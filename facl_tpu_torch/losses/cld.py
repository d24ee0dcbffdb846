"""CLD (cross-level discrimination) with k-means on the device
(counterpart of facl_tpu/losses/cld.py:24-77).

k-means's centroid update is a one-hot product, as in the JAX package,
and the gradient flows through it: JAX differentiates ``onehot.T @ x``
through its loop, so the centroids are not detached here either (the
labels, from argmin, carry none).
"""
from __future__ import annotations

from typing import Tuple

import torch

from facl_tpu_torch.losses.infonce import cross_entropy
from facl_tpu_torch.ops.grouping import pairwise_sqdist


def kmeans(x: torch.Tensor, num_clusters: int = 60, num_iters: int = 5
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd iterations from the first K rows. x (N, D) -> (labels (N,)
    int64, centroids (K, D)). argmin takes the first minimum; an empty
    cluster divides its zero sum by a count of 1."""
    N, K = x.shape[0], num_clusters
    if N < K:
        raise ValueError(f"kmeans: {N} rows cannot seed {K} clusters "
                         "(cld_clusters must not exceed 3 x batch)")
    c = x[:K]
    ks = torch.arange(K, device=x.device)
    for _ in range(num_iters):
        labels = pairwise_sqdist(x, c).argmin(1)
        # A comparison, not F.one_hot, which checks its labels on the host
        # (a device sync per call on the card).
        onehot = (labels[:, None] == ks).to(x.dtype)
        counts = onehot.sum(0).clamp_min(1.0)
        c = (onehot.T @ x) / counts[:, None]
    return pairwise_sqdist(x, c).argmin(1), c


def cld_pair_loss(f1: torch.Tensor, f2: torch.Tensor, temp: float = 0.05,
                  num_clusters: int = 60, num_iters: int = 5
                  ) -> torch.Tensor:
    """Symmetric cross-cluster cross-entropy between two feature groups."""
    l1, c1 = kmeans(f1, num_clusters, num_iters)
    l2, c2 = kmeans(f2, num_clusters, num_iters)
    loss = cross_entropy((f1 @ c2.T) / temp, l2)
    return (loss + cross_entropy((f2 @ c1.T) / temp, l1)) / 2.0


def cld_loss(x_nor: torch.Tensor, temp: float = 0.05,
             num_clusters: int = 60, num_iters: int = 5) -> torch.Tensor:
    """CLD over sliding 3-crop windows: for i in 0..G-5, crops i..i+2
    against crops i+1..i+3, summed (0 when G < 5). x_nor (G, B, D)."""
    G, B, D = x_nor.shape
    flat = x_nor.reshape(G * B, D)
    loss = torch.zeros((), dtype=x_nor.dtype, device=x_nor.device)
    for i in range(G - 4):
        loss = loss + cld_pair_loss(flat[i * B:(i + 3) * B],
                                    flat[(i + 1) * B:(i + 4) * B], temp,
                                    num_clusters, num_iters)
    return loss
