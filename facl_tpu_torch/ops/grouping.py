"""kNN + ball-query grouping (counterpart of facl_tpu/ops/grouping.py).

Semantics of utils_my.py:255-291 as the JAX package implements them: the
first S points of each cloud are the centroids; each takes its K nearest
points, any farther than ``radius_sq`` (a *squared* distance) replaced by
the centroid itself; the gathered xyz are re-centred on the centroid.

Routing follows ``GroupingConfig.select_impl`` / ``gather_impl`` as the
JAX package routes them (facl_tpu/ops/grouping.py:132-177):

  select  gather
  pallas  pallas   the fused select+gather, kernel B1 (ops/select.py)
  pallas  xla      kernel B4 (selection only), then ``torch.gather``
  xla     pallas   the plain composite (pairwise_sqdist -> K smallest ->
                   radius override), then kernel B5a (ops/gather.py)
  xla     xla      the plain composite, then ``torch.gather``

"auto" means "pallas" on every device (the port's rule: its kernels run
on the card and their plain twins on the CPU). ``method="approx"``
(JAX: ``lax.approx_min_k``) takes the plain selection with any
``select_impl``, as the JAX package does, then the gather
``gather_impl`` names; its K smallest come from ``torch.topk``, exact
(on JAX's CPU backend ``approx_min_k`` returns the exact set too).
Every route is differentiable in the points: B1's and B5a's backward is the scatter-add
B5b. Neighbour order within the K differs between routes (B1 and B4:
in-radius points by ascending index, centroid padding at the tail; the
composite: ascending distance); everything downstream reduces over K.
"""
from __future__ import annotations

from typing import Tuple

import torch

from facl_tpu_torch.config import GroupingConfig
from facl_tpu_torch.ops.gather import gather_rows_vjp
from facl_tpu_torch.ops.select import select_gather_knn_ball, \
    select_knn_ball

IMPLS = ("auto", "xla", "pallas")
METHODS = ("exact", "approx")


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances |a|^2 - 2ab + |b|^2, clamped at 0.
    a: (..., S, D), b: (..., N, D) -> (..., S, N)."""
    a2 = (a * a).sum(-1, keepdim=True)
    b2 = (b * b).sum(-1, keepdim=True)
    ab = torch.einsum("...sd,...nd->...sn", a, b)
    return (a2 - 2.0 * ab + b2.transpose(-1, -2)).clamp_min(0.0)


def knn_ball_plain(points: torch.Tensor, S: int, K: int,
                   radius_sq: float) -> torch.Tensor:
    """The plain composite selection (facl_tpu/ops/grouping.py:158-163):
    squared distances of every point to the first S, the K smallest in
    ascending order (smaller index first among equal distances, as
    ``lax.top_k``), any farther than ``radius_sq`` replaced by the
    centroid's own index. Returns idx (B, S, K) int64."""
    N = points.shape[1]
    xyz = points[..., :3]
    d = pairwise_sqdist(xyz[:, :S], xyz)                      # (B, S, N)
    n = torch.arange(N, device=points.device)
    # (distance bits, index) order; d >= 0, so its bits order as d does.
    comp = d.view(torch.int32).to(torch.int64) * N + n
    idx = torch.topk(comp, K, dim=-1, largest=False).indices
    s_col = torch.arange(S, device=points.device).view(1, S, 1)
    return torch.where(torch.gather(d, -1, idx) > radius_sq, s_col, idx)


def _pad_c(centers: torch.Tensor, C: int) -> torch.Tensor:
    """(B, S, 3) -> (B, S, C), zeros past xyz: the re-centring offset.
    Subtracted out of place: the kernels' outputs are autograd Function
    outputs, which may not be modified in place."""
    return torch.nn.functional.pad(centers, (0, C - 3))


def group_points(points: torch.Tensor, num_centroids: int = 64,
                 knn_k: int = 64, radius_sq: float = 0.06,
                 layout: str = "bskc", method: str = "exact",
                 select_impl: str = "auto", gather_impl: str = "auto"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """points (B, N, C), xyz in channels 0:3. Returns (neighbourhoods with
    xyz re-centred — (B, S, K, C), or (B, C, S, K) for ``layout="bcsk"``
    —, centers (B, S, 3)). Differentiable in ``points``."""
    if layout not in ("bskc", "bcsk"):
        raise ValueError(f"unknown layout {layout!r}")
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{METHODS}")
    for name, v in (("select_impl", select_impl),
                    ("gather_impl", gather_impl)):
        if v not in IMPLS:
            raise ValueError(f"unknown {name} {v!r}; expected one of {IMPLS}")
    B, N, C = points.shape
    S, K = num_centroids, knn_k
    if K > N:
        raise ValueError(f"knn_k={K} exceeds the {N} points per cloud")
    if S > N:
        raise ValueError(f"num_centroids={S} exceeds the {N} points per "
                         "cloud (centroids are the first S points)")
    points = points.float().contiguous()
    centers = points[:, :S, :3]
    # "approx" takes the plain selection, whatever select_impl says
    # (facl_tpu/ops/grouping.py:132-163).
    kernel_select = select_impl != "xla" and method == "exact"
    kernel_gather = gather_impl != "xla"
    if kernel_select and kernel_gather:
        grouped = select_gather_knn_ball(points, S, K, radius_sq)
        grouped = grouped - _pad_c(centers, C).transpose(1, 2)[..., None]
        if layout == "bskc":
            grouped = grouped.permute(0, 2, 3, 1).contiguous()
        return grouped, centers.contiguous()
    if kernel_select:
        idx = select_knn_ball(points, S, K, radius_sq)
    else:
        idx = knn_ball_plain(points, S, K, radius_sq)
    if kernel_gather:
        grouped = gather_rows_vjp(points, idx.to(torch.int32)
                                  .reshape(B, S * K))
    else:
        grouped = torch.gather(
            points, 1, idx.long().reshape(B, S * K, 1).expand(B, S * K, C))
    grouped = grouped.reshape(B, S, K, C) - _pad_c(centers, C)[:, :, None]
    if layout == "bcsk":
        grouped = grouped.permute(0, 3, 1, 2).contiguous()
    return grouped, centers.contiguous()


def resolve_gather_impl(cfg: GroupingConfig) -> str:
    """The gather route of ``cfg``, decided once at build time: an explicit
    "pallas"/"xla" is honoured; "auto" stays "auto", which takes the
    kernels on every device (the port runs on one device, so the JAX
    package's multi-device downgrade, grouping.py:180-196, never
    applies); group_points rejects an unknown value."""
    return cfg.gather_impl


def resolve_select_impl(cfg: GroupingConfig) -> str:
    """Same rule for the selection (see :func:`resolve_gather_impl`)."""
    return cfg.select_impl


def group_points_cfg(points: torch.Tensor, cfg: GroupingConfig,
                     layout: str = "bskc"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    return group_points(points, cfg.num_centroids, cfg.knn_k,
                        cfg.radius_sq, layout, cfg.method,
                        resolve_select_impl(cfg), resolve_gather_impl(cfg))


def group_points_level2(features: torch.Tensor, num_centroids: int = 64,
                        knn_k: int = 32, radius_sq: float = 0.11
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Second-level grouping over abstracted features
    (facl_tpu/ops/grouping.py:223-241; utils_my.py:332-381): features
    (B, S1, 3 + F), xyz then learned features a first-level group; the
    first ``num_centroids`` rows are the centroids; the whole feature
    vector is gathered and only xyz re-centred. Routed as
    :func:`group_points` routes "auto": kernel B1 on the card."""
    return group_points(features, num_centroids, knn_k, radius_sq,
                        "bskc", "exact")
