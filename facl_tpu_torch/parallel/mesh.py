"""The data-parallel mesh (counterpart of facl_tpu/parallel/mesh.py).

JAX lays the devices out as a ``('dp', 'mp')`` mesh and lets GSPMD derive
every collective. Here the mesh is the process group of the ranks: each
rank holds one contiguous block of the batch axis, the parameters are
replicated, and the collectives of parallel/collectives.py make the step
compute what the unsharded step computes (global BatchNorm statistics,
negatives over the global batch, gradients of the global loss).

Tensor parallelism (``mp > 1``, JAX's ``param_sharding`` of the wide FC
kernels) is not ported: no shipped config sets it (ROADMAP Queue 1
item 20).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from facl_tpu_torch.config import MeshConfig


@dataclass(frozen=True)
class Mesh:
    """``dp`` ranks over the batch axis; this process is ``rank``.
    ``group`` is the process group, or None for one process that joined
    none (then every collective is the identity)."""
    dp: int
    rank: int = 0
    group: Optional[Any] = None

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "mp": 1}


def make_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The mesh of ``cfg`` over the ranks of the process group (one
    process when there is none). ``dp=-1`` takes every rank; ``dp * mp``
    must equal the number of ranks (facl_tpu/parallel/mesh.py:30-32)."""
    cfg = cfg or MeshConfig()
    if cfg.mp > 1:
        raise NotImplementedError(
            f"mesh mp={cfg.mp}: tensor parallelism is not ported (ROADMAP "
            "Queue 1 item 20); use mp=1")
    world = dist.get_world_size() if dist.is_initialized() else 1
    dp = cfg.dp if cfg.dp > 0 else world
    if dp != world:
        raise ValueError(f"mesh {dp}x1 needs {dp} ranks, have {world}")
    if not dist.is_initialized():
        return Mesh(dp=1)
    return Mesh(dp=dp, rank=dist.get_rank(), group=dist.group.WORLD)


def distributed(mesh: Optional[Mesh]) -> bool:
    """True where the collectives run: a mesh with a process group."""
    return mesh is not None and mesh.group is not None


def batch_slice(mesh: Optional[Mesh], batch: int) -> slice:
    """This rank's contiguous block of a batch axis of ``batch`` entries:
    rank r holds ``[r * batch / dp, (r + 1) * batch / dp)``, as
    ``batch_sharding(mesh, batch_axis)`` lays a dp-sharded axis out."""
    if mesh is None:
        return slice(0, batch)
    if batch % mesh.dp:
        raise ValueError(f"batch of {batch} does not divide over "
                         f"dp={mesh.dp} ranks")
    n = batch // mesh.dp
    return slice(mesh.rank * n, (mesh.rank + 1) * n)


def shard_train_state(mesh: Optional[Mesh], state, extra=()):
    """Every rank takes rank 0's parameters, BatchNorm buffers, Adam
    state, SwAV queue and the tensors ``extra`` (the port's placement of a
    replicated state: after this call the ranks hold the same state bit
    for bit). One broadcast of all of it, packed in float64 (exact for the
    f32 tensors), on the rank's device. The LR scheduler and the update
    count are host values that a fresh init or a restore of the same files
    already gives every rank alike. Returns ``state``."""
    from facl_tpu_torch.parallel.collectives import broadcast
    if not distributed(mesh):
        return state
    tensors = list(state.model.parameters()) + list(state.model.buffers())
    for per_param in state.optimizer.state.values():
        tensors += [t for t in per_param.values()
                    if isinstance(t, torch.Tensor)]
    if state.swav_queue is not None:
        tensors.append(state.swav_queue)
    tensors += list(extra)
    dev = next(state.model.parameters()).device
    flat = torch.cat([t.detach().reshape(-1).to(dev, torch.float64)
                      for t in tensors])
    broadcast(flat, mesh)
    with torch.no_grad():
        for t, v in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(v.view(t.shape))
    return state
