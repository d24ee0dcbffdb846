"""Depth-frame preprocessing: masking, motion localisation and
back-projection (counterpart of facl_tpu/datagen/depth.py:26-80).

Every function takes frames with any leading batch axes (..., H, W), on
dense pixel grids with validity masks, as the JAX package does. The
static border wipe of the reference (generate_NTU.py:339-351) is
reproduced as it behaves: the top two rows and left two columns only.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from facl_tpu_torch.config import DatagenConfig


def f32_reciprocal(v: float) -> float:
    """1 / v rounded to f32. The JAX generator runs under jit, where XLA
    turns a division by a constant into a product with the constant's f32
    reciprocal; the port forms the same product (a true division differs
    by an ulp in about one value in five, and moves a voxel's floor where
    the value sits at an integer)."""
    return float(np.float32(1.0) / np.float32(v))


def mask_depth(depth: torch.Tensor,
               boundary_seg: Tuple[int, int, int, int] = (60, 29, 10, 10)
               ) -> torch.Tensor:
    """Border and data-dependent boundary masking of (..., H, W) frames:
    zero the top 2 rows and left 2 columns; then, from each frame's
    nonzero extent, the top ``seg[0]`` rows, rows >= last nonzero row -
    ``seg[1]``, columns < first nonzero column + ``seg[2]`` and columns
    >= last nonzero column - ``seg[3]``. An empty frame keeps its full
    extents."""
    H, W = depth.shape[-2:]
    d = depth.clone()
    d[..., 0:2, :] = 0.0
    d[..., :, 0:2] = 0.0
    nz = d != 0
    rows, cols = nz.any(-1), nz.any(-2)
    ridx = torch.arange(H, device=d.device)
    cidx = torch.arange(W, device=d.device)
    any_nz = nz.flatten(-2).any(-1)
    last_row = torch.where(any_nz, torch.where(rows, ridx, -1).amax(-1),
                           H - 1)
    min_col = torch.where(any_nz, torch.where(cols, cidx, W).amin(-1), 0)
    max_col = torch.where(any_nz, torch.where(cols, cidx, -1).amax(-1),
                          W - 1)
    rmask = (ridx >= boundary_seg[0]) & \
        (ridx < (last_row - boundary_seg[1])[..., None])
    cmask = (cidx >= (min_col + boundary_seg[2])[..., None]) & \
        (cidx < (max_col - boundary_seg[3])[..., None])
    return d * rmask[..., :, None].to(d.dtype) * cmask[..., None, :].to(
        d.dtype)


def locate_motion(prev: torch.Tensor, cur: torch.Tensor, low: float = 50.0,
                  high: float = 300.0) -> torch.Tensor:
    """Frame differencing: the current depth where |cur - prev| lies
    strictly inside (low, high), else 0."""
    diff = (cur - prev).abs()
    moving = (diff > low) & (diff < high)
    return torch.where(moving, cur, torch.zeros_like(cur))


def backproject(depth: torch.Tensor, cfg: DatagenConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pinhole back-projection of (..., H, W) frames -> (points
    (..., H*W, 3) camera-space xyz, valid (..., H*W) bool); invalid
    pixels carry zeros. ``(xx - cx) * depth / fx`` in that order, the
    division as the product :func:`f32_reciprocal` says, so each voxel's
    floor lands where the JAX generator's does."""
    H, W = depth.shape[-2:]
    xx = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :]
    yy = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None]
    valid = depth > 0
    X = (xx - cfg.cx) * depth * f32_reciprocal(cfg.fx)
    Y = (yy - cfg.cy) * depth * f32_reciprocal(cfg.fy)
    pts = torch.stack([X, Y, depth], dim=-1)
    pts = torch.where(valid[..., None], pts, torch.zeros_like(pts))
    lead = depth.shape[:-2]
    return pts.reshape(*lead, H * W, 3), valid.reshape(*lead, H * W)
