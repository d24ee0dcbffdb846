"""B5: batched row gather and its scatter-add transpose.

Counterpart of ``facl_tpu/ops/pallas/gather.py``: ``gather_rows`` (B5a,
the TPU kernel's pallas_call at gather.py:72), ``scatter_add_rows`` (B5b,
:126) and ``gather_rows_vjp`` (:144), the gather whose backward is the
scatter-add. The CUDA kernels live in ``csrc/gather.cu``.

A CPU tensor takes the plain twin (``torch.gather``, ``index_add_``); a
CUDA tensor launches the kernel or raises. B5a is a copy and equals its
twin bit for bit. B5b sorts each cloud's rows by point (stably, so each
point's rows stay in ascending order) and sums them in an order fixed
by the rows per point and the block size (spans of the sorted list, the
runs that cross a span's end combined left to right), so it is
deterministic; ``index_add_`` adds with atomics on the card, in no
fixed order.
"""
from __future__ import annotations

import torch

from facl_tpu_torch.ops import _build
from facl_tpu_torch.ops._launch import need, on_cpu


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor
                      ) -> torch.Tensor:
    B, N, C = table.shape
    R = idx.shape[1]
    return torch.gather(table, 1,
                        idx.long()[..., None].expand(B, R, C))


def scatter_add_rows_plain(idx: torch.Tensor, grads: torch.Tensor,
                           n: int) -> torch.Tensor:
    B, R, C = grads.shape
    rows = (idx.long() + n * torch.arange(B, device=idx.device)[:, None])
    out = torch.zeros(B * n, C, dtype=grads.dtype, device=grads.device)
    out.index_add_(0, rows.reshape(-1), grads.reshape(B * R, C))
    return out.view(B, n, C)


_ARGS = [_build.P, _build.P] + [_build.I] * 4 + [_build.P, _build.P]
#: Threads of a B5b block (csrc/gather.cu kSThreads).
_THREADS = 512
#: Dynamic shared memory a B5b block may take (csrc/gather.cu kMaxSmem:
#: Hopper's 227 KB less 1 KB for the kernel's static shared variables).
MAX_SMEM = 226 * 1024


def scatter_smem(n: int, R: int, C: int) -> int:
    """Bytes of shared memory B5b needs for one cloud of n points and R
    rows of C channels, g not staged (csrc/gather.cu scatter_words): idx
    (R ints, at least 4 a thread: the span sums take its room after the
    sort), the sorted rows (R ints) and the counts (16 warps' 16-bit
    counts a point: n x 8 ints), whose room takes the output (n x C
    floats) after the sort; each region rounded up to 16 bytes. g (R x C
    floats) is staged too where two blocks still fit on an SM."""
    def pad(k):
        return -(-k // 4) * 4
    return 4 * (max(pad(R), 4 * _THREADS) + pad(R) + pad(n * max(C, 8)))


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """B5a. table (B, N, C) f32, idx (B, R) int32 in [0, N) -> (B, R, C):
    out[b, r] = table[b, idx[b, r]]."""
    if on_cpu(table, "gather_rows"):
        return gather_rows_plain(table, idx)
    B, N, C = table.shape
    R = idx.shape[1]
    need(table, (B, N, C), "gather_rows table")
    need(idx, (B, R), "gather_rows idx", torch.int32)
    out = torch.empty((B, R, C), dtype=torch.float32, device=table.device)
    lib, fn = _build.function("gather", "facl_gather_rows", _ARGS)
    code = fn(_build.ptr(table), _build.ptr(idx), B, N, R, C,
              _build.ptr(out), _build.stream_of(table))
    gather_rows.launches += 1
    _build.check(lib, code, "gather_rows")
    return out


def scatter_add_rows(idx: torch.Tensor, grads: torch.Tensor,
                     n: int) -> torch.Tensor:
    """B5b. idx (B, R) int32 in [0, n), grads (B, R, C) f32 -> (B, n, C):
    out[b, i] = sum of grads[b, r] over the r with idx[b, r] == i."""
    if on_cpu(grads, "scatter_add_rows"):
        return scatter_add_rows_plain(idx, grads, n)
    B, R, C = grads.shape
    need(grads, (B, R, C), "scatter_add_rows grads")
    need(idx, (B, R), "scatter_add_rows idx", torch.int32)
    if scatter_smem(n, R, C) > MAX_SMEM:
        raise ValueError(f"scatter_add_rows kernel: n={n} points, R={R} "
                         f"rows and C={C} channels per cloud need "
                         f"{scatter_smem(n, R, C)} bytes of shared memory, "
                         f"more than {MAX_SMEM}")
    out = torch.empty((B, n, C), dtype=torch.float32, device=grads.device)
    lib, fn = _build.function("gather", "facl_scatter_add_rows", _ARGS)
    code = fn(_build.ptr(idx), _build.ptr(grads), B, n, R, C,
              _build.ptr(out), _build.stream_of(grads))
    scatter_add_rows.launches += 1
    _build.check(lib, code, "scatter_add_rows")
    return out


KERNELS = (gather_rows, scatter_add_rows)
for _k in KERNELS:
    _k.launches = 0


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[1]
        return gather_rows(table, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return scatter_add_rows(idx, g.contiguous(), ctx.n), None


def gather_rows_vjp(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Differentiable :func:`gather_rows`; its backward is B5b."""
    return _GatherRows.apply(table, idx)
