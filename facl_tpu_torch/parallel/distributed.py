"""Process-group set-up (counterpart of facl_tpu/parallel/distributed.py).

JAX's ``initialize`` joins the hosts of a pod before the global mesh is
built; here one process runs per rank (``torchrun``, or ``spawn`` in
parallel/launch.py) and ``initialize`` joins them in one
``torch.distributed`` process group. The backend is the caller's: NCCL
(one card a rank) by default, gloo only when asked for. Nothing switches
backend or device on its own.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

#: Seconds a collective may wait before it raises (a rank that died or
#: hangs then fails the others instead of holding them forever).
DEFAULT_TIMEOUT_S = 600.0


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def initialize(backend: str = "nccl", init_method: Optional[str] = None,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join this process to the ranks' process group; True when this call
    made the group (the caller then leaves it with :func:`finalize`).

    ``rank``/``world_size`` default to torchrun's ``RANK``/``WORLD_SIZE``,
    ``init_method`` to ``env://`` (torchrun's ``MASTER_ADDR``/
    ``MASTER_PORT``); the tests pass a ``file://`` store. A no-op for one
    process without an ``init_method``, as JAX's is on one host, and when
    the group already exists. With CUDA the rank's card is made current:
    ``cuda:{LOCAL_RANK % device_count}``. NCCL takes one card a rank, so
    asking for it with more ranks on this host (``LOCAL_WORLD_SIZE``) than
    cards raises here, before any rendezvous; gloo may put several ranks
    on one card."""
    if dist.is_initialized():
        return False
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None \
        else world_size
    if world_size == 1 and init_method is None:
        return False
    rank = _env_int("RANK", 0) if rank is None else rank
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world_size)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and local_world > cards:
        raise RuntimeError(
            f"backend nccl needs one CUDA device a rank: {local_world} "
            f"rank(s) on this host, {cards} device(s). Start fewer ranks, "
            "or name --dist-backend gloo to share a device")
    if cards:
        torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def rank_device(device="cuda") -> torch.device:
    """The device of this rank: the current card for ``cuda`` (set by
    :func:`initialize`), else ``device`` as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def finalize() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
