"""What every kernel wrapper past B1 (ops/sa_pair.py, sa_fwd.py, sa_bwd.py,
sa_kernel.py, gather.py) shares: the device rule (a CPU tensor takes the plain twin, a CUDA tensor
launches), the argument checks that raise ``ValueError`` on what a kernel
does not take, the grid, the fixed-order reduction of per-block float64
partials, and the ctypes launch."""
from __future__ import annotations

import ctypes

import torch

from facl_tpu_torch.ops import _build

TILE = 64          # rows per kernel tile (csrc/sa_tile.cuh TR)
TRUNK = (64, 64, 256)

P, I = _build.P, _build.I
L = ctypes.c_int64
ptr = _build.ptr
stream_of = _build.stream_of


def on_cpu(t: torch.Tensor, what: str = "SA sweeps") -> bool:
    """True for a CPU tensor (run the twin); False for CUDA (launch)."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return False


def need(t: torch.Tensor, shape, name: str, dtype=torch.float32):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_c0(C0: int, R: int):
    if not 1 <= C0 <= 7 or R % TILE:
        raise ValueError(f"the SA kernels take 1 <= C0 <= 7 input channels"
                         f" and a row count divisible by {TILE}; got "
                         f"C0={C0}, rows={R}")


def check_x(x3: torch.Tensor, dtype=torch.float32):
    """Channel-major input (B, C0, N) stored as ``dtype``."""
    B, C0, N = x3.shape
    need(x3, (B, C0, N), "x", dtype)
    check_c0(C0, B * N)
    return B, C0, N


def check_pool(R: int, pool: int):
    if R % TILE or R % pool or (TILE % pool and pool % TILE):
        raise ValueError(f"the SA kernels take pool sizes dividing or "
                         f"divisible by {TILE}, and row counts divisible by "
                         f"both; got pool={pool}, rows={R}")


def reduce(part: torch.Tensor) -> torch.Tensor:
    """Sum per-block float64 partials in a fixed order; float32 out."""
    return part.sum(0).float()


def grid(t: torch.Tensor, R: int, per_sm: int = 2) -> int:
    """Persistent blocks: ``per_sm`` per SM (what the kernel's shared
    memory lets reside at once), at most one per row tile."""
    return min(R // TILE, per_sm * _build.sm_count(t.device))


def need_aligned(t: torch.Tensor, name: str):
    """Kernels that stage rows by TMA bulk copies take 16-byte aligned
    rows."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel stages rows by 16-byte bulk "
                         "copies and takes a 16-byte aligned tensor")


def entry(name: str, dt) -> str:
    """The C entry point of sweep ``name`` for rows stored as ``dt``:
    facl_sa_<name>, or facl_sa_<name>_bf16."""
    return f"facl_sa_{name}" + ("_bf16" if dt == torch.bfloat16 else "")


def launch(lib: str, name: str, argtypes, *args, what: str):
    handle, fn = _build.function(lib, name, argtypes)
    _build.check(handle, fn(*args), what)
