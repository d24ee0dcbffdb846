"""Profiling / tracing hooks (counterpart of facl_tpu/utils/profiling.py).

``trace`` profiles a region with ``torch.profiler`` (host and, where
present, CUDA activity) and writes a Chrome trace into a directory (open
it in Perfetto or chrome://tracing); ``StepTimer`` times steps on the
host clock, synchronising the device before each reading so a step's
time includes its device work, and derives clips/s.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional, Union

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed region into ``log_dir``/trace.json (no-op
    when None)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """``with timer: step()`` appends each step's seconds to ``times``;
    the first ``warmup`` are left out of the steady-state figures."""

    def __init__(self, clips_per_step: int, warmup: int = 2,
                 device: Union[str, torch.device, None] = None):
        self.clips_per_step = clips_per_step
        self.warmup = warmup
        self.device = torch.device(device) if device is not None else None
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)

    @property
    def steady_times(self) -> List[float]:
        return self.times[self.warmup:] if len(self.times) > self.warmup \
            else self.times

    @property
    def mean_step_seconds(self) -> float:
        ts = self.steady_times
        return sum(ts) / len(ts) if ts else 0.0

    def clips_per_sec(self, n_chips: int = 1) -> float:
        m = self.mean_step_seconds
        return self.clips_per_step / m / max(n_chips, 1) if m else 0.0
