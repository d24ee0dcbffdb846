"""The collectives of the data-parallel step (counterpart of
facl_tpu/parallel/collectives.py).

Under GSPMD, XLA inserts these itself; in eager torch each is one call on
the mesh's process group:

  psum              sum over the ranks: the pair stage's sweep
                    accumulators (B6s, ops/sa_pair.py)
  global_moments    (mean, var) of a batch over every rank's rows, by a
                    differentiable sum of (sum x, sum x^2): BatchNorm with
                    global statistics (SyncBN on flax's biased variance)
  gather_negatives  the global embedding batch in rank order, this
                    rank's block differentiable
  all_gather        the same without a gradient (extraction)
  psum_grads        the gradient sum over the ranks, in one buffer
  broadcast         rank 0's tensor on every rank
  barrier           every rank waits for the others (checkpoints)
  cross_replica_mean  the mean over the ranks

Each is the identity where no process group runs (``mesh`` None, or one
process that joined none: ``parallel.mesh.distributed`` false), so the
one-process step runs no collective. Each counts in ``<function>.calls``
the collectives it ran (forward and backward), as the kernel wrappers
count launches.

The gathers are one all_reduce of zeroed per-rank slots, each rank
writing its own: exact (a value plus zeros) and the same code on every
backend and device, so no tensor leaves its device behind the caller's
back.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from facl_tpu_torch.parallel.mesh import Mesh, distributed


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def psum(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Sum of ``t`` over the ranks (a new tensor; no gradient)."""
    if not distributed(mesh):
        return t
    psum.calls += 1
    return _all_reduce(t.detach().clone(), mesh)


def psum_packed(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]
                ) -> List[torch.Tensor]:
    """Each of ``tensors`` summed over the ranks, by one :func:`psum` of
    one float64 buffer; each comes back in its own dtype and shape."""
    if not distributed(mesh):
        return list(tensors)
    flat = psum(torch.cat([t.reshape(-1).to(torch.float64)
                           for t in tensors]), mesh)
    return [v.view(t.shape).to(t.dtype) for t, v in
            zip(tensors, flat.split([t.numel() for t in tensors]))]


class _SumOverRanks(torch.autograd.Function):
    """y = sum over ranks of x; its cotangent is the sum over ranks of
    the ranks' cotangents of y (each rank differentiates the loss through
    its own rows only)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        global_moments.calls += 1
        return _all_reduce(x.clone(), mesh)

    @staticmethod
    def backward(ctx, dy):
        global_moments.calls += 1
        return _all_reduce(dy.contiguous().clone(), ctx.mesh), None


def global_moments(flat: torch.Tensor, mesh: Optional[Mesh]):
    """Batch (mean, var) over the channel axis of rows ``flat`` (R, C):
    the biased variance E[x^2] - E[x]^2 clamped at 0, as flax's BatchNorm
    (facl_tpu_torch/models/layers.py). With a process group the moments
    are over every rank's rows (each rank holding R of them, as the mesh
    splits the batch evenly), differentiable through the sum."""
    if not distributed(mesh):
        mean = flat.mean(0)
        return mean, ((flat * flat).mean(0) - mean * mean).clamp_min(0.0)
    C, n = flat.shape[-1], flat.shape[0] * mesh.dp
    s = _SumOverRanks.apply(torch.cat([flat.sum(0), (flat * flat).sum(0)]),
                            mesh)
    mean = s[:C] / n
    return mean, (s[C:] / n - mean * mean).clamp_min(0.0)


def all_gather(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's ``x`` (same shape on each) concatenated along dim 0 in
    rank order; no gradient."""
    if not distributed(mesh):
        return x
    all_gather.calls += 1
    return _slots(x, mesh).reshape(-1, *x.shape[1:])


def _slots(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    buf = x.new_zeros((mesh.dp, *x.shape))
    buf[mesh.rank] = x.detach()
    return _all_reduce(buf, mesh)


def gather_negatives(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global negative pool: every rank's ``x`` along dim 0 in rank
    order, with this rank's block the differentiable ``x`` itself and the
    others detached (facl_tpu/parallel/collectives.py:17-25)."""
    if not distributed(mesh):
        return x
    gather_negatives.calls += 1
    blocks = list(_slots(x, mesh).unbind(0))
    blocks[mesh.rank] = x
    return torch.cat(blocks)


def psum_grads(params: Iterable[torch.nn.Parameter],
               mesh: Optional[Mesh]) -> None:
    """Sum the ``.grad`` of ``params`` over the ranks, in place, in one
    all_reduce of one buffer. A sum, not JAX's pmean: every rank
    differentiates the global loss through its own block of the batch, so
    the ranks' gradients add up to the global loss's. Parameters without
    a gradient are left out (the same on every rank)."""
    if not distributed(mesh):
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    psum_grads.calls += 1
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view(g.shape))


def broadcast(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Rank 0's ``t`` on every rank, in place; returns ``t``."""
    if not distributed(mesh):
        return t
    broadcast.calls += 1
    dist.broadcast(t, src=0, group=mesh.group)
    return t


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait until every rank reaches this call."""
    if not distributed(mesh):
        return
    barrier.calls += 1
    dist.barrier(group=mesh.group)


def cross_replica_mean(x: torch.Tensor, mesh: Optional[Mesh]
                       ) -> torch.Tensor:
    """The mean of ``x`` over the ranks (no gradient)."""
    if not distributed(mesh):
        return x
    cross_replica_mean.calls += 1
    return _all_reduce(x.detach().clone(), mesh) / mesh.dp


COLLECTIVES = (psum, global_moments, gather_negatives, all_gather,
               psum_grads, broadcast, barrier, cross_replica_mean)
for _c in COLLECTIVES:
    _c.calls = 0
