"""ctypes bridge to the native batch .npy loader (``native/npy_loader.cc``,
shared with the JAX package, which has its own bridge:
facl_tpu/data/native.py).

The source is compiled with g++ on first use into
``build/facl_tpu_torch/`` under the repository root (named by a hash of
the source and the flags, like the CUDA kernels, ops/_build.py), never
into ``native/``. Where no C++ toolchain is found the loader is reported
unavailable and the dataset loads with NumPy; this is host I/O, not a
device path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "npy_loader.cc"
BUILD_DIR = ROOT / "build" / "facl_tpu_torch"
FLAGS = ["-O3", "-std=c++17", "-fPIC", "-pthread", "-shared"]

_lock = threading.Lock()
_lib: dict = {}


def _lib_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"npy_loader-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)          # atomic against a concurrent loader
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None without a toolchain
    (or without the source)."""
    with _lock:
        if "lib" in _lib:
            return _lib["lib"]
        lib = None
        if SOURCE.exists():
            out = _lib_path()
            if out.exists() or _build(out):
                lib = ctypes.CDLL(str(out))
                lib.nl_load_batch.restype = ctypes.c_int64
                lib.nl_load_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32]
        _lib["lib"] = lib
        return lib


def native_available() -> bool:
    return get_lib() is not None


def load_into(paths: Sequence[str], out: torch.Tensor,
              num_threads: int = 4) -> None:
    """Load ``len(paths)`` .npy files of shape ``out.shape[1:]`` into the
    rows of ``out``, a contiguous float32 CPU tensor (pinned or not),
    converting to float32 on the way, in parallel outside the GIL. A file
    the native parser does not take (another dtype or byte order) is
    loaded by NumPy into its row, as facl_tpu/data/native.py:97-101 does.
    Raises on a file of another shape."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native .npy loader unavailable (no C++ "
                           "toolchain); use the NumPy path")
    n, shape = len(paths), tuple(out.shape[1:])
    if out.dtype != torch.float32 or not out.is_contiguous() or \
            out.device.type != "cpu" or out.shape[0] != n:
        raise ValueError(f"out must be a contiguous float32 CPU tensor with "
                         f"{n} rows; got {out.dtype} {tuple(out.shape)}")
    elems = out[0].numel()
    shapes = np.zeros((n, 4), np.int64)
    ndims = np.zeros(n, np.int32)
    counts = np.zeros(n, np.int64)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.nl_load_batch(c_paths, n, out.data_ptr(), elems, shapes.ctypes.data,
                      ndims.ctypes.data, counts.ctypes.data, num_threads)
    for i in range(n):
        got = tuple(int(d) for d in shapes[i, :ndims[i]])
        if counts[i] == 0:
            a = np.load(paths[i])
            got = a.shape
            if got == shape:
                out[i].copy_(torch.from_numpy(a.astype(np.float32)))
        if got != shape:
            raise ValueError(f"{paths[i]}: shape {got}, expected {shape}")
