"""MoCo: the momentum key encoder, the negative queue and the [pos | queue]
logits (counterpart of facl_tpu/models/moco.py).

JAX threads the key parameters, the queue and its pointer through pure
functions; here the key encoder is a module of the query encoder's
structure whose parameters ``momentum_update`` moves in place, and the
queue is a (K, D) f32 tensor on the encoders' device that ``enqueue``
writes in place. The pointer is a host int.

Under tensor parallelism the query holds column blocks of its wide
Denses (models/layers.py::ColumnDense) while the key encoder is whole: the
key takes the query's full tensors, gathered over the mp ranks
(``full_state_dict``, ``full_parameters``), and its f32 EMA is then the
same on every rank.

The queue's first draw is the port's own (``torch.randn`` from an explicit
generator, rows L2-normalised): JAX draws it with threefry, which torch
cannot reproduce, so the tests carry JAX's queue across with
``convert.moco_state_from_jax``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Optional, Sequence, Tuple

import torch
from torch import nn

from facl_tpu_torch.models.layers import full_parameters, full_state_dict


@dataclass
class MoCoState:
    """The key encoder (eval mode, no gradients), the ring queue of
    negative keys (K, D) f32 and the next row to write."""
    key_encoder: nn.Module
    queue: torch.Tensor
    queue_ptr: int = 0


def init_moco_state(query: nn.Module, key: nn.Module, dim: int = 512,
                    queue_len: int = 9600,
                    generator: Optional[torch.Generator] = None
                    ) -> MoCoState:
    """``key`` (built like ``query``, whole) takes the query's parameters
    and buffers (every rank calls this under tensor parallelism); the
    queue is ``queue_len`` unit rows of a normal draw from
    ``generator`` (made on the CPU, then moved to the query's device), as
    facl_tpu/models/moco.py:32-41 draws its own."""
    key.load_state_dict(full_state_dict(query))
    key.eval().requires_grad_(False)
    q = torch.randn(queue_len, dim, generator=generator)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    device = next(query.parameters()).device
    return MoCoState(key.to(device), q.to(device), 0)


@torch.no_grad()
def momentum_update(query_params: Iterable[torch.Tensor],
                    key_params: Iterable[torch.Tensor],
                    m: float = 0.9) -> None:
    """key <- key * m + query * (1 - m), in place, pairwise over the two
    sequences (facl_tpu/models/moco.py:44-48)."""
    for k, q in zip(key_params, query_params):
        k.copy_(k * m + q * (1.0 - m))


@torch.no_grad()
def enqueue(state: MoCoState, keys: torch.Tensor) -> MoCoState:
    """Write ``keys`` (B, D) at the pointer and advance it modulo the
    queue length (facl_tpu/models/moco.py:51-58). The write starts at
    ``min(ptr, K - B)``, where ``lax.dynamic_update_slice`` clamps it;
    with K a multiple of B, as the trainers make it, that is the pointer.
    Returns ``state``."""
    B, K = keys.shape[0], state.queue.shape[0]
    start = min(state.queue_ptr, K - B)
    state.queue[start:start + B] = keys.to(state.queue.dtype)
    state.queue_ptr = (state.queue_ptr + B) % K
    return state


def moco_logits(q: torch.Tensor, k: torch.Tensor, queue: torch.Tensor,
                temperature: float = 1.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """InfoNCE logits [pos | queue negatives] / temperature, label 0
    (facl_tpu/models/moco.py:61-69). The queue is read, not
    differentiated."""
    l_pos = (q * k).sum(1, keepdim=True)                     # (B, 1)
    l_neg = q @ queue.detach().T                             # (B, K)
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    return logits, torch.zeros(q.shape[0], dtype=torch.long,
                               device=q.device)


def moco_step(encode: Callable[..., torch.Tensor], query: nn.Module,
              state: MoCoState, query_inputs: Sequence, key_inputs: Sequence,
              m: float = 0.9, temperature: float = 1.0):
    """One MoCo forward (facl_tpu/models/moco.py:72-86): encode the
    query, move the key encoder towards the query, encode the keys
    without a gradient, build the logits against the queue as it was, then
    enqueue the keys. ``encode(module, *inputs) -> (B, D)``. Returns
    (logits, labels, state)."""
    q = encode(query, *query_inputs)
    momentum_update(full_parameters(query), state.key_encoder.parameters(),
                    m)
    with torch.no_grad():
        k = encode(state.key_encoder, *key_inputs)
    logits, labels = moco_logits(q, k, state.queue.clone(), temperature)
    enqueue(state, k)
    return logits, labels, state
