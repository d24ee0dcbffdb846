"""B1: fused kNN + ball-query selection and channel-major gather.

Counterpart of ``facl_tpu/ops/pallas/select.py::select_gather_knn_ball``
(the TPU kernel ``_select_gather``, pallas_call at select.py:302). Per
centroid (the first S points of each cloud) it selects the exact K nearest
of the N points by squared distance, smaller index first among ties; any
selected point farther than ``radius_sq`` is dropped and its slot padded
with the centroid's own index (utils_my.py:255-291 semantics). Selected
in-radius points are listed in ascending point index with the padding at
the tail — the TPU kernel's order — and the C channels are gathered into
(B, C, S, K), not re-centred.

:func:`select_gather` launches the CUDA kernel (``csrc/select.cu``) for a
CUDA tensor and runs :func:`select_gather_plain` for a CPU tensor. The two
compute the distance with the same rounded operations in the same order,
so they agree bit for bit.

:func:`select_knn_ball` is kernel B4 (select.py::select_knn_ball,
pallas_call :258): the same selection without the gather, the same CUDA
template with the gather compiled out. :func:`select_gather_knn_ball` is
B1 made differentiable (select.py:329-363): the selection is piecewise
constant in the points, so the gradient is the gather's, the scatter-add
B5b (ops/gather.py) over the saved indices, on every device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from facl_tpu_torch.ops import _build

INT_MAX = 2**31 - 1


def sqdist_to_centroids(points: torch.Tensor, S: int) -> torch.Tensor:
    """(B, N, C) -> (B, S, N) squared distances of every point to each of
    the first S points: (c2 - 2 ab) + p2 clamped at 0, with the dot and
    the squared norms summed x, y, z left to right (the kernel's order)."""
    x, y, z = (points[..., i] for i in range(3))
    p2 = x * x + y * y + z * z                                # (B, N)
    cx, cy, cz = (v[:, :S, None] for v in (x, y, z))
    ab = cx * x[:, None, :] + cy * y[:, None, :] + cz * z[:, None, :]
    d = p2[:, :S, None] - 2.0 * ab + p2[:, None, :]
    return d.clamp_min(0.0)


def select_knn_ball_plain(points: torch.Tensor, S: int, K: int,
                          radius_sq: float) -> torch.Tensor:
    """Plain PyTorch twin of the B4 kernel (and B1's selection): idx
    (B, S, K) int32."""
    B, N, C = points.shape
    d = sqdist_to_centroids(points, S)
    r2 = torch.tensor(radius_sq, dtype=torch.float32, device=points.device)
    key = torch.where(d <= r2, d.view(torch.int32),
                      torch.full_like(d, INT_MAX, dtype=torch.int32))
    n = torch.arange(N, device=points.device)
    # (key, index) lexicographic order = smaller index first among ties.
    comp = key.to(torch.int64) * N + n
    chosen = torch.topk(comp, K, dim=-1, largest=False).indices
    valid = torch.gather(key, -1, chosen) < INT_MAX
    cand = torch.where(valid, chosen, torch.full_like(chosen, N))
    cand = torch.sort(cand, dim=-1).values
    s_col = torch.arange(S, device=points.device).view(1, S, 1)
    return torch.where(cand < N, cand, s_col.expand_as(cand)).to(torch.int32)


def select_gather_plain(points: torch.Tensor, S: int, K: int,
                        radius_sq: float) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Plain PyTorch twin of the B1 kernel. Returns (grouped (B, C, S, K)
    f32, idx (B, S, K) int32)."""
    B, N, C = points.shape
    idx = select_knn_ball_plain(points, S, K, radius_sq)
    pts_t = points.transpose(1, 2)                           # (B, C, N)
    grouped = torch.gather(
        pts_t, 2, idx.long().reshape(B, 1, S * K).expand(B, C, S * K))
    return grouped.reshape(B, C, S, K), idx


def _check_points(points: torch.Tensor, S: int, K: int, what: str) -> bool:
    """Shared argument rule of B1 and B4; True for a CPU tensor (twin)."""
    B, N, C = points.shape
    if K > N or S > N:
        raise ValueError(f"S={S}, K={K} must not exceed the {N} points")
    if points.device.type == "cpu":
        return True
    if points.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {points.device}")
    if points.dtype != torch.float32 or not points.is_contiguous():
        raise ValueError(f"{what}: points must be contiguous float32")
    if C < 3 or N > 1024:
        raise ValueError(f"{what} kernel takes C >= 3 and N <= 1024, "
                         f"got C={C}, N={N}")
    return False


def select_gather(points: torch.Tensor, S: int, K: int, radius_sq: float,
                  return_idx: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused select+gather. points: (B, N, C) f32 with xyz in channels
    0:3. Returns (grouped (B, C, S, K), idx (B, S, K) int32 or None).

    A CPU tensor takes the plain twin; a CUDA tensor launches the kernel
    (building it at first use) or raises."""
    B, N, C = points.shape
    if _check_points(points, S, K, "select_gather"):
        grouped, idx = select_gather_plain(points, S, K, radius_sq)
        return grouped, (idx if return_idx else None)
    lib, fn = _build.function(
        "select", "facl_select_gather",
        [_build.P] + [_build.I] * 5 + [_build.F] + [_build.P] * 3)
    grouped = torch.empty((B, C, S, K), dtype=torch.float32,
                          device=points.device)
    idx = (torch.empty((B, S, K), dtype=torch.int32, device=points.device)
           if return_idx else None)
    code = fn(_build.ptr(points), B, N, C, S, K, float(radius_sq),
              _build.ptr(grouped),
              _build.ptr(idx) if idx is not None else None,
              _build.stream_of(points))
    select_gather.launches += 1
    _build.check(lib, code, "select_gather")
    return grouped, idx


def select_knn_ball(points: torch.Tensor, S: int, K: int,
                    radius_sq: float) -> torch.Tensor:
    """B4: the selection of :func:`select_gather` alone. points (B, N, C)
    f32, xyz in channels 0:3. Returns idx (B, S, K) int32, bit-equal to
    B1's."""
    B, N, C = points.shape
    if _check_points(points, S, K, "select_knn_ball"):
        return select_knn_ball_plain(points, S, K, radius_sq)
    lib, fn = _build.function(
        "select", "facl_select_knn_ball",
        [_build.P] + [_build.I] * 5 + [_build.F] + [_build.P] * 2)
    idx = torch.empty((B, S, K), dtype=torch.int32, device=points.device)
    code = fn(_build.ptr(points), B, N, C, S, K, float(radius_sq),
              _build.ptr(idx), _build.stream_of(points))
    select_knn_ball.launches += 1
    _build.check(lib, code, "select_knn_ball")
    return idx


KERNELS = (select_gather, select_knn_ball)
for _k in KERNELS:
    _k.launches = 0


class _SelectGather(torch.autograd.Function):
    """B1 forward; backward the scatter-add (B5b) of the channel-major
    cotangent, transposed to rows first (select.py:345-363)."""

    @staticmethod
    def forward(ctx, points, S, K, radius_sq):
        grouped, idx = select_gather(points, S, K, radius_sq,
                                     return_idx=True)
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return grouped

    @staticmethod
    def backward(ctx, g):
        from facl_tpu_torch.ops.gather import scatter_add_rows
        idx, = ctx.saved_tensors
        B, C, S, K = g.shape
        rows = g.permute(0, 2, 3, 1).reshape(B, S * K, C).contiguous()
        return (scatter_add_rows(idx.reshape(B, S * K), rows, ctx.n),
                None, None, None)


def select_gather_knn_ball(points: torch.Tensor, S: int, K: int,
                           radius_sq: float) -> torch.Tensor:
    """Differentiable B1: gathered neighbourhoods (B, C, S, K), not
    re-centred."""
    return _SelectGather.apply(points, S, K, radius_sq)
