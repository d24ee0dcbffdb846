"""Checkpoint / resume (counterpart of facl_tpu/train/checkpoint.py:24-81).

The full TrainState round-trips: the module's parameters and BatchNorm
running statistics, Adam's moments, the LR scheduler, the update count
and the SwAV queue where SwAV is on (a file without one, SwAV off or
written before the queue was saved, leaves the target's queue). The
slow/fast state is a TrainState of another module; the MoCo state
(``MoCoTrainState``) adds the key encoder, the negative queue and its
pointer, and restores only into a MoCo state. One
``ckpt_epoch_{epoch:05d}.pt`` file per checkpoint plus ``index.json``
(``latest_epoch``, ``latest``), each written to a temp file and renamed,
so a crash mid-write never corrupts the latest; the oldest files beyond
``keep`` are pruned.

Files are ``torch.save`` of tensors and plain containers only, and are
read with ``weights_only=True``. The LR schedule is a closure
(``LambdaLR``), which a state dict does not keep: the target's scheduler,
built from the config, keeps its closure and takes the saved counters,
so the learning rate after a resume equals an uninterrupted run's.

Under data parallelism (``mesh``) the ranks hold the same state: rank 0
writes, and every rank waits at a barrier until the files are in place;
every rank restores the same files. Under tensor parallelism (``mp > 1``)
every rank gathers the full tensors of the split kernels and of their
Adam moments over its mp group before rank 0 writes, so the file is the
one one process writes and restores on any mesh: a restore loads the
full tensors and each rank keeps its blocks (models/layers.py::
ColumnDense, ``shard_optimizer_state``).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

import torch

from facl_tpu_torch.models.layers import full_optimizer_state_dict, \
    full_state_dict, shard_optimizer_state
from facl_tpu_torch.parallel.collectives import barrier
from facl_tpu_torch.parallel.mesh import Mesh, tensor_parallel
from facl_tpu_torch.train.state import TrainState

PREFIX, SUFFIX = "ckpt_epoch_", ".pt"


def _atomic_write(directory: str, path: str, write) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _payload(state: TrainState) -> dict:
    """The state as the file holds it, split kernels whole (a gather over
    the mp ranks: every rank of the mp block calls this)."""
    out = {"model": full_state_dict(state.model),
           "optimizer": full_optimizer_state_dict(state.optimizer,
                                                  state.model),
           "scheduler": state.scheduler.state_dict(),
           "step": int(state.step)}
    if state.swav_queue is not None:
        out["swav_queue"] = state.swav_queue
    moco = getattr(state, "moco", None)
    if moco is not None:
        out["moco"] = {"key_encoder": moco.key_encoder.state_dict(),
                       "queue": moco.queue, "queue_ptr": int(moco.queue_ptr)}
    return out


def save_checkpoint(directory: str, state: TrainState, epoch: int,
                    keep: int = 20, mesh: Optional[Mesh] = None) -> str:
    """Write ``state`` as epoch ``epoch``'s checkpoint (rank 0 only under
    a ``mesh``; the others wait for it). Returns its path."""
    path = os.path.join(directory, f"{PREFIX}{epoch:05d}{SUFFIX}")
    lead = mesh is None or mesh.lead
    # Rank 0's mp block gathers its split tensors together.
    gather = tensor_parallel(mesh) and mesh.rank == 0
    payload = _payload(state) if lead or gather else None
    if lead:
        os.makedirs(directory, exist_ok=True)
        _atomic_write(directory, path, lambda f: torch.save(payload, f))
        index = {"latest_epoch": epoch, "latest": os.path.basename(path)}
        _atomic_write(directory, os.path.join(directory, "index.json"),
                      lambda f: f.write(json.dumps(index).encode()))
        _prune(directory, keep)
    barrier(mesh)
    return path


def _prune(directory: str, keep: int) -> None:
    ckpts = sorted(p for p in os.listdir(directory)
                   if p.startswith(PREFIX) and p.endswith(SUFFIX))
    for p in ckpts[:-keep] if keep > 0 else []:
        os.unlink(os.path.join(directory, p))


def latest_checkpoint(directory: str) -> Optional[str]:
    idx = os.path.join(directory, "index.json")
    if not os.path.exists(idx):
        return None
    with open(idx) as f:
        name = json.load(f)["latest"]
    path = os.path.join(directory, name)
    return path if os.path.exists(path) else None


def restore_checkpoint(path: str, target: TrainState) -> TrainState:
    """Restore into a freshly built ``target`` (same config; shapes must
    match, split kernels whole in the file), onto the device of its
    parameters; a target on a mesh with ``mp > 1`` keeps its blocks.
    Returns ``target``."""
    device = next(target.model.parameters()).device
    saved = torch.load(path, map_location=device, weights_only=True)
    moco = getattr(target, "moco", None)
    if ("moco" in saved) != (moco is not None):
        kind = "a MoCo" if "moco" in saved else "a non-MoCo"
        raise ValueError(f"{path}: {kind} checkpoint, restored into a "
                         f"{type(target).__name__}")
    target.model.load_state_dict(saved["model"])
    target.optimizer.load_state_dict(saved["optimizer"])
    shard_optimizer_state(target.optimizer, target.model)
    target.scheduler.load_state_dict(saved["scheduler"])
    target.step = int(saved["step"])
    if "swav_queue" in saved:
        target.swav_queue = saved["swav_queue"].to(device)
    if moco is not None:
        moco.key_encoder.load_state_dict(saved["moco"]["key_encoder"])
        moco.queue = saved["moco"]["queue"].to(device)
        moco.queue_ptr = int(saved["moco"]["queue_ptr"])
    return target


def restore_latest(directory: str, target: TrainState
                   ) -> Optional[TrainState]:
    path = latest_checkpoint(directory)
    return restore_checkpoint(path, target) if path else None
