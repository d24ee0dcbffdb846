"""Sinkhorn normalisation and the SwAV swap-prediction loss (counterpart
of facl_tpu/losses/sinkhorn.py:25-135).

Sinkhorn's few iterations are a plain loop of tensor ops over a
(prototypes x samples) matrix per crop, as the JAX package computes them
outside any kernel. The targets carry no gradient (``no_grad``), so only
the prediction side, ``log_softmax(code / temp_pred)``, is differentiated.
Under a data-parallel mesh the trainer hands in the gathered global
``code`` and ``x_nor`` and every rank runs this on the same arrays, as
GSPMD runs the JAX step, so no collective is needed here.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def shoot_infs(x: torch.Tensor) -> torch.Tensor:
    """Replace +-inf entries by the max over the whole matrix (the last
    two axes) of the entries that are not inf (zero where they were)."""
    mask = torch.isinf(x)
    zeroed = torch.where(mask, torch.zeros_like(x), x)
    m = zeroed.amax(dim=(-2, -1), keepdim=True)
    return torch.where(mask, m.expand_as(x), zeroed)


def sinkhorn(Q: torch.Tensor, num_iters: int = 3) -> torch.Tensor:
    """Sinkhorn-Knopp row/column balancing. Q: (..., K, N) positive
    scores (prototypes x samples); returns the (..., N, K) assignment
    ``(Q / colsum).T``. All-zero columns (a queue that is off scores
    -inf, exp makes 0) stay zero instead of going NaN."""
    Q = shoot_infs(Q)
    Q = Q / Q.sum(dim=(-2, -1), keepdim=True)
    K, N = Q.shape[-2:]
    r, c = 1.0 / K, 1.0 / N
    zero = torch.zeros((), dtype=Q.dtype, device=Q.device)
    for _ in range(num_iters):
        u = shoot_infs((r / Q.sum(-1))[..., None])[..., 0]
        Q = Q * u[..., :, None]
        s = Q.sum(-2)
        Q = Q * torch.where(s > 0, c / s, zero)[..., None, :]
    colsum = Q.sum(-2, keepdim=True)
    return (Q / torch.where(colsum > 0, colsum, zero + 1)).transpose(-2, -1)


def swav_loss(code: torch.Tensor, x_nor: torch.Tensor,
              mapping_weight: torch.Tensor, queue: Optional[torch.Tensor],
              use_queue: Union[bool, torch.Tensor],
              temp_code: float = 0.03, temp_pred: float = 0.1,
              num_iters: int = 3
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """SwAV over the first G-1 crops: each crop's Sinkhorn targets q
    (from its queue-extended prototype scores) are predicted from every
    other participating crop's softmaxed code.

    code (G, B, P) prototype logits; x_nor (G, B, D) normalised
    embeddings (enqueued for later steps); mapping_weight (D, P), the JAX
    kernel's layout (the transpose of ``nn.Linear.weight``); queue
    (G-1, Q, D) or None; use_queue a bool or a 0-d bool tensor (when
    false the queued scores are -inf, so they drop out of Sinkhorn).
    Returns (loss, the queue shifted by B with the fresh embeddings in
    front, or None)."""
    G, B, P = code.shape
    Gm1 = G - 1
    part = code[:Gm1]                                        # (G-1, B, P)
    with torch.no_grad():
        po = part.detach()
        if queue is not None:
            scores = queue @ mapping_weight.detach()          # (G-1, Q, P)
            if isinstance(use_queue, torch.Tensor):   # no host sync
                scores = torch.where(use_queue, scores,
                                     torch.full_like(scores, -torch.inf))
            elif not use_queue:
                scores = torch.full_like(scores, -torch.inf)
            po = torch.cat([scores, po], dim=1)
        po = torch.exp(po / temp_code).transpose(1, 2)        # (G-1, P, Q+B)
        q_all = sinkhorn(po, num_iters)[:, -B:]               # (G-1, B, P)
    logp = torch.log_softmax(part / temp_pred, dim=-1)
    ce = torch.einsum("abp,vbp->av", q_all, logp) / B         # (G-1, G-1)
    off = 1.0 - torch.eye(Gm1, dtype=ce.dtype, device=ce.device)
    loss = -(ce * off).sum() / Gm1
    new_queue = None
    if queue is not None:
        new_queue = torch.cat([x_nor[:Gm1].detach().to(queue.dtype),
                               queue[:, :-B]], dim=1)
    return loss, new_queue


def swav_queue_init(num_crops: int, queue_len: int, dim: int,
                    device: Union[str, torch.device] = "cpu"
                    ) -> torch.Tensor:
    """The zero queue (G-1, Q, D), f32."""
    return torch.zeros(num_crops - 1, queue_len, dim, dtype=torch.float32,
                       device=device)
