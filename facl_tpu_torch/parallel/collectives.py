"""The collectives of the sharded step (counterpart of
facl_tpu/parallel/collectives.py).

Under GSPMD, XLA inserts these itself; in eager torch each is one call on
one of the mesh's process groups (parallel/mesh.py). Over the dp group
(``COLLECTIVES``; "the ranks" below are the dp group's):

  psum              sum over the ranks: the pair stage's sweep
                    accumulators (B6s, ops/sa_pair.py) and analytic's
                    backward sums (ops/analytic_sa.py)
  global_moments    (mean, var) of a batch over every rank's rows, by a
                    differentiable sum of (sum x, sum x^2): BatchNorm with
                    global statistics (SyncBN on flax's biased variance);
                    ``global_gram`` (covar's Gram and column sums) counts
                    here too
  gather_negatives  the global embedding batch in rank order, this
                    rank's block differentiable
  all_gather        the same without a gradient (extraction)
  psum_grads        the gradient sum over the ranks, in one buffer
  broadcast         global rank 0's tensor on every rank (over the world)
  barrier           every rank waits for the others (over the world;
                    checkpoints)
  cross_replica_mean  the mean over the ranks

Over the mp group (``MP_COLLECTIVES``, tensor parallelism):

  mp_enter          the input of a column-split GEMM: identity forward,
                    the cotangent summed over the mp ranks backward
  mp_gather_cols    the column blocks of a GEMM's output joined in mp
                    order; backward, this rank's block of the cotangent
  mp_full           a split tensor's full value (dim 0 blocks joined),
                    no gradient: checkpoints, placement, the MoCo EMA

Each is the identity where its group does not run (``mesh`` None, one
process that joined none, a dp of 1, an mp of 1), so the one-process step
runs no collective. Each counts in ``<function>.calls`` the collectives
it ran (forward and backward), as the kernel wrappers count launches.

The gathers are one all_reduce of zeroed per-rank slots, each rank
writing its own: exact (a value plus zeros) and the same code on every
backend and device, so no tensor leaves its device behind the caller's
back.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist

from facl_tpu_torch.parallel.mesh import Mesh, distributed, joined, \
    tensor_parallel


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


def global_gram(flat: torch.Tensor, mesh: Optional[Mesh]):
    """(Gram(flat), colsum(flat)) of rows ``flat`` (R, C) over every
    rank's rows, differentiable through the sum (covar's BatchNorm
    moments, models/sa_stage.py::covar_moments). Counted as
    ``global_moments``."""
    gram, ch = flat.T @ flat, flat.sum(0)
    if not distributed(mesh):
        return gram, ch
    C = flat.shape[-1]
    s = _SumOverRanks.apply(torch.cat([gram.reshape(-1), ch]), mesh)
    return s[:C * C].view(C, C), s[C * C:]


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
    """Global rank 0's ``t`` on every rank of the mesh (dp and mp), in
    place; returns ``t``."""
    if not joined(mesh):
        return t
    broadcast.calls += 1
    dist.broadcast(t, src=0)
    return t


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait until every rank of the mesh reaches this call."""
    if not joined(mesh):
        return
    barrier.calls += 1
    dist.barrier()


def cross_replica_mean(x: torch.Tensor, mesh: Optional[Mesh]
                       ) -> torch.Tensor:
    """The mean of ``x`` over the ranks (no gradient)."""
    if not distributed(mesh):
        return x
    cross_replica_mean.calls += 1
    return _all_reduce(x.detach().clone(), mesh) / mesh.dp


# -- tensor parallelism: over the mp group ------------------------------

def _mp_all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.mp_group)
    return t


def _mp_all_gather(t: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """The mp ranks' ``t`` (same shape on each), in mp order."""
    out = [torch.empty_like(t) for _ in range(mesh.mp)]
    dist.all_gather(out, t, group=mesh.mp_group)
    return out


class _MpEnter(torch.autograd.Function):
    """y = x; dx = the sum over the mp ranks of dy. ``x`` is the input of
    a GEMM on this rank's block of a kernel's columns, so each rank's dy
    is its block's share of the full input gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        mp_enter.calls += 1
        return _mp_all_reduce(dy.contiguous().clone(), ctx.mesh), None


def mp_enter(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x``, whose cotangent is summed over the mp ranks (the input of a
    column-parallel GEMM: the layers below then get the full input
    gradient on every rank)."""
    if not tensor_parallel(mesh):
        return x
    return _MpEnter.apply(x, mesh)


class _MpGatherCols(torch.autograd.Function):
    """y = the mp ranks' column blocks x joined along the last axis, in
    mp order; dx = this rank's block of dy, with no sum: everything after
    the gather is replicated over the mp ranks, so each holds the full
    dy."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.cols = mesh, x.shape[-1]
        mp_gather_cols.calls += 1
        return torch.cat(_mp_all_gather(x.contiguous(), mesh), dim=-1)

    @staticmethod
    def backward(ctx, dy):
        c, m = ctx.cols, ctx.mesh.mp_rank
        return dy[..., m * c:(m + 1) * c].contiguous(), None


def mp_gather_cols(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The full output of a column-parallel GEMM from this rank's column
    block ``x``: the blocks of the mp ranks joined along the last axis."""
    if not tensor_parallel(mesh):
        return x
    return _MpGatherCols.apply(x, mesh)


def mp_full(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The full tensor of which ``t`` is this rank's dim-0 block (a split
    kernel's rows in ``nn.Linear`` layout, or its Adam moments): the mp
    ranks' blocks joined along dim 0; no gradient."""
    if not tensor_parallel(mesh):
        return t
    mp_full.calls += 1
    return torch.cat(_mp_all_gather(t.detach().contiguous(), mesh))


COLLECTIVES = (psum, global_moments, gather_negatives, all_gather,
               psum_grads, broadcast, barrier, cross_replica_mean)
MP_COLLECTIVES = (mp_enter, mp_gather_cols, mp_full)
for _c in COLLECTIVES + MP_COLLECTIVES:
    _c.calls = 0
