"""The ``dp x mp`` mesh (counterpart of facl_tpu/parallel/mesh.py).

JAX lays the devices out as a ``('dp', 'mp')`` mesh and lets GSPMD derive
every collective. Here the mesh is the process groups of the ranks, laid
out as JAX lays out the devices (``devices[:dp*mp].reshape(dp, mp)``):
rank ``r`` sits at ``(d, m) = (r // mp, r % mp)``.

- The batch axis is split over ``dp``: the ranks of one ``d`` (an "mp
  block") hold the same block of the batch. ``Mesh.group`` is the dp
  group, the ranks that share ``m``; every batch collective of
  parallel/collectives.py (BatchNorm moments, negatives, gradient sums,
  B6s) runs over it and makes the step compute what the unsharded step
  computes (global BatchNorm statistics, negatives over the global batch,
  gradients of the global loss).
- With ``mp > 1`` the wide Dense kernels are split over ``mp`` (JAX's
  ``param_sharding``, :func:`mp_sharded`): each rank of an mp block holds
  one block of a kernel's output columns (models/layers.py::ColumnDense),
  and the ``mp`` collectives run over ``Mesh.mp_group``, the ranks that
  share ``d``. Everything else is replicated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from facl_tpu_torch.config import MeshConfig

#: JAX's rule (facl_tpu/parallel/mesh.py:67-82): a 2-D kernel with at
#: least this many output columns is split over ``mp``.
MP_MIN_COLUMNS = 512


@dataclass(frozen=True)
class Mesh:
    """``dp`` blocks of the batch axis times ``mp`` blocks of the wide
    kernels' columns; this process is at ``(rank, mp_rank)``. ``group``
    is the dp group (None where it holds one rank, or for one process
    that joined no group: then every batch collective is the identity);
    ``mp_group`` the mp group (None for ``mp == 1``)."""
    dp: int
    rank: int = 0
    group: Optional[Any] = None
    mp: int = 1
    mp_rank: int = 0
    mp_group: Optional[Any] = None

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "mp": self.mp}

    @property
    def global_rank(self) -> int:
        return self.rank * self.mp + self.mp_rank

    @property
    def lead(self) -> bool:
        """True on global rank 0: the rank that writes files and logs."""
        return self.global_rank == 0


def make_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The mesh of ``cfg`` over the ranks of the process group (one
    process when there is none). ``dp=-1`` takes every rank ``mp`` leaves;
    ``dp * mp`` must equal the number of ranks (facl_tpu/parallel/
    mesh.py:25-33 takes any mesh up to the device count; under torchrun
    every process is a rank, and a smaller mesh would leave ranks out of
    the collectives). Every rank creates every group, in one order, as
    ``dist.new_group`` demands."""
    cfg = cfg or MeshConfig()
    world = dist.get_world_size() if dist.is_initialized() else 1
    mp = max(1, cfg.mp)
    dp = cfg.dp if cfg.dp > 0 else max(1, world // mp)
    if dp * mp != world:
        raise ValueError(f"mesh {dp}x{mp} needs {dp * mp} ranks, have "
                         f"{world}")
    if not dist.is_initialized():
        return Mesh(dp=1)
    d, m = divmod(dist.get_rank(), mp)
    if mp == 1:
        return Mesh(dp=dp, rank=d, group=dist.group.WORLD)
    dp_groups = [dist.new_group([e * mp + k for e in range(dp)])
                 for k in range(mp)] if dp > 1 else [None] * mp
    mp_groups = [dist.new_group([e * mp + k for k in range(mp)])
                 for e in range(dp)]
    return Mesh(dp=dp, rank=d, group=dp_groups[m], mp=mp, mp_rank=m,
                mp_group=mp_groups[d])


def distributed(mesh: Optional[Mesh]) -> bool:
    """True where the batch collectives run: a mesh with a dp group."""
    return mesh is not None and mesh.group is not None


def tensor_parallel(mesh: Optional[Mesh]) -> bool:
    """True where the wide kernels are split: a mesh with an mp group."""
    return mesh is not None and mesh.mp_group is not None


def joined(mesh: Optional[Mesh]) -> bool:
    """True where this process runs with others (a dp or an mp group)."""
    return distributed(mesh) or tensor_parallel(mesh)


def mp_sharded(mesh: Optional[Mesh], jax_shape: Sequence[int]) -> bool:
    """JAX's ``param_sharding`` rule on a parameter of JAX layout
    ``jax_shape`` (a Dense kernel is (in, out)): split over ``mp`` where
    the mesh has ``mp > 1`` and the tensor is 2-D with at least
    ``MP_MIN_COLUMNS`` output columns. Biases and every 1-D tensor stay
    replicated. (``nn.Linear.weight`` is (out, in): its test is
    ``weight.shape[0] >= 512``.)"""
    return mesh is not None and mesh.mp > 1 and len(jax_shape) == 2 and \
        jax_shape[-1] >= MP_MIN_COLUMNS


def batch_slice(mesh: Optional[Mesh], batch: int) -> slice:
    """This rank's contiguous block of a batch axis of ``batch`` entries:
    block d holds ``[d * batch / dp, (d + 1) * batch / dp)``, as
    ``batch_sharding(mesh, batch_axis)`` lays a dp-sharded axis out (the
    mp ranks of a block hold the same entries)."""
    if mesh is None:
        return slice(0, batch)
    if batch % mesh.dp:
        raise ValueError(f"batch of {batch} does not divide over "
                         f"dp={mesh.dp} ranks")
    n = batch // mesh.dp
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_train_state(mesh: Optional[Mesh], state, extra=()):
    """Place a state on the mesh (facl_tpu/parallel/mesh.py:49-65). Every
    rank takes global rank 0's parameters, BatchNorm buffers, Adam state,
    SwAV queue and the tensors ``extra``; then each rank keeps its block
    of every split kernel and of its Adam moments (their full tensors are
    gathered over the mp group first, so rank 0's full state is what
    travels). One broadcast of all of it, packed in float64 (exact for
    the f32 tensors), on the rank's device. The LR scheduler and the
    update count are host values that a fresh init or a restore of the
    same files already gives every rank alike. Returns ``state``."""
    from facl_tpu_torch.models.layers import column_blocks
    from facl_tpu_torch.parallel.collectives import broadcast, mp_full
    if not joined(mesh):
        return state
    blocks = column_blocks(state.model, state.optimizer)
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    for per_param in state.optimizer.state.values():
        tensors += [t for t in per_param.values()
                    if isinstance(t, torch.Tensor)]
    if state.swav_queue is not None:
        tensors.append(state.swav_queue)
    tensors += list(extra)
    full = [mp_full(t, mesh) if id(t) in blocks else t for t in tensors]
    dev = next(state.model.parameters()).device
    flat = torch.cat([t.detach().reshape(-1).to(dev, torch.float64)
                      for t in full])
    broadcast(flat, mesh)
    with torch.no_grad():
        for t, f, v in zip(tensors, full, flat.split([f.numel()
                                                      for f in full])):
            v = v.view(f.shape)
            t.copy_(blocks[id(t)].block(v) if id(t) in blocks else v)
    return state
