"""Start a function on several ranks, one process each, and collect what
each returns (no JAX counterpart: a GSPMD program is one process).

``spawn`` is for tests and measurement scripts; training runs under
``torchrun`` (README). The ranks meet at a ``file://`` store in a fresh
temporary directory, so no TCP port is taken and concurrent launches
cannot collide. The parent waits with a deadline: on the first rank that
fails, or when the deadline passes, it kills every rank still running and
raises, with the failing rank's traceback. A rank that hangs in a
collective therefore costs the deadline, not the caller's whole budget.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch

from facl_tpu_torch.parallel import distributed


def _rank_main(fn: Callable, rank: int, world_size: int, backend: str,
               store: str, out: str, args: Sequence[Any],
               timeout_s: float) -> None:
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world_size))
    try:
        distributed.initialize(backend, init_method=f"file://{store}",
                               rank=rank, world_size=world_size,
                               timeout_s=timeout_s)
        result = fn(*args)
        torch.save(result, os.path.join(out, f"result_{rank}.pt"))
    except BaseException:
        # The traceback goes to the parent, which raises it; exit 1.
        with open(os.path.join(out, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)
    finally:
        distributed.finalize()


def _read(path: str) -> str:
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def spawn(fn: Callable, world_size: int, backend: str = "gloo",
          args: Sequence[Any] = (), timeout_s: float = 120.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` ranks, each in a new process
    (``spawn`` start method) joined to one process group of ``backend``
    (``parallel.distributed.initialize``). ``fn`` and ``args`` must pickle
    (``fn`` a module-level function); each rank's return value comes back
    through ``torch.save``, so return CPU tensors and plain containers.
    Returns the ranks' values in rank order. Raises RuntimeError with the
    traceback of the first rank that failed, or TimeoutError when
    ``timeout_s`` passes first; either way no rank is left running."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="facl-spawn-")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, store, tmp,
                               tuple(args), timeout_s))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while True:
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed or all(p.exitcode == 0 for p in procs):
                break
            if time.monotonic() > deadline:
                alive = [r for r, p in enumerate(procs) if p.is_alive()]
                raise TimeoutError(f"spawn: rank(s) {alive} of {world_size} "
                                   f"still running after {timeout_s:g} s; "
                                   "killed")
            time.sleep(0.05)
        if failed:
            r = failed[0]
            tb = _read(os.path.join(tmp, f"error_{r}.txt")) or \
                f"(no traceback: exit code {procs[r].exitcode})"
            raise RuntimeError(f"spawn: rank {r} of {world_size} failed\n{tb}")
        return [torch.load(os.path.join(tmp, f"result_{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
