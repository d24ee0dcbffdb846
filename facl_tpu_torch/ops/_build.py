"""Build and load the hand-written CUDA kernels (``ops/csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds, not minutes. Libraries land in
``build/facl_tpu_torch/`` under the repository root, named by a hash of
the source, the shared headers and the flags: a changed source is rebuilt,
an unchanged one is loaded as is. Only the package's own sources are
compiled. Nothing is built at import time; the first CUDA launch (or an
explicit :func:`build_all`) builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "facl_tpu_torch"
SOURCES = ("select", "sa_pair", "sa_2sweep", "sa_layer", "gather",
           "sa_fused")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("facl_tpu_torch: nvcc not found (PATH, CUDA_HOME "
                           "or /usr/local/cuda/bin); the CUDA kernels are "
                           "built from source at first use")
    return str(path)


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


class _Registry:
    """Loaded libraries of this process, built on first request."""

    def __init__(self):
        self._libs: Dict[str, ctypes.CDLL] = {}
        self._lock = threading.Lock()
        self.build_log: Dict[str, str] = {}

    def _start(self, name: str):
        out = _lib_path(name)
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, out

    def _finish(self, name: str, started) -> None:
        if started is None:
            return
        proc, tmp, out = started
        log, _ = proc.communicate()
        self.build_log[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)       # atomic: a concurrent loader never
                                   # sees a half-written library

    def build(self, names: List[str]) -> float:
        """Build ``names`` in parallel (one nvcc each). Returns seconds."""
        t0 = time.perf_counter()
        started = {n: self._start(n) for n in names}
        errors = []
        for n, s in started.items():
            try:
                self._finish(n, s)
            except RuntimeError as e:   # finish the others, then report
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return time.perf_counter() - t0

    def get(self, name: str) -> ctypes.CDLL:
        with self._lock:
            lib = self._libs.get(name)
            if lib is None:
                self.build([name])
                lib = ctypes.CDLL(str(_lib_path(name)))
                lib.facl_error_string.argtypes = [ctypes.c_int]
                lib.facl_error_string.restype = ctypes.c_char_p
                self._libs[name] = lib
            return lib


REGISTRY = _Registry()


def build_all() -> float:
    """Compile every kernel source (in parallel) and load it; seconds."""
    dt = REGISTRY.build(list(SOURCES))
    for n in SOURCES:
        REGISTRY.get(n)
    return dt


_FUNCTIONS: Dict[tuple, tuple] = {}


def function(lib_name: str, fn_name: str, argtypes):
    """A launcher of library ``lib_name`` with its ctypes signature set;
    launchers return an int (cudaGetLastError()). Resolved once per
    process: only a name's first use takes the registry's lock."""
    hit = _FUNCTIONS.get((lib_name, fn_name))
    if hit is None:
        lib = REGISTRY.get(lib_name)
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        hit = _FUNCTIONS[(lib_name, fn_name)] = (lib, fn)
    return hit


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launcher."""
    if code != 0:
        msg = lib.facl_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({code}: {msg})")


# ctypes argument kinds: every pointer and the stream are c_void_p (a bare
# Python int would be passed as a 32-bit int and cut the pointer).
P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t):
    """The raw handle of the current stream on ``t``'s device (without
    building a ``torch.cuda.Stream`` per launch)."""
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.device.index))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """The device's SM count, queried once per device and process."""
    index = device.index
    return _sm_count(torch.cuda.current_device() if index is None else index)
