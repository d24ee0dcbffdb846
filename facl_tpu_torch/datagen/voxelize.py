"""Temporal rank pooling over voxel grids and density denoising
(counterpart of facl_tpu/datagen/voxelize.py:53-181; the 3DV core of
generate_NTU.py:369-440).

Each frame's points fill a binary occupancy grid (a scatter-max, which
dedupes a voxel hit several times in one frame and gives the same grid
in any order, so the card's result is deterministic); M=5 channels sum
the grids weighted by rank coefficients, channel 0 over the whole clip
and channels 1-4 over four half-overlapping windows; a key grid sums the
motion-located points' grids with the global coefficient. The
coefficients are integers and so are the sums, exact in f32 in any order:
a block of frames is weighted by one batched product. The 3^3 denoise
counts occupied neighbours (integers <= 27) by box sums.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

from facl_tpu_torch.config import DatagenConfig
from facl_tpu_torch.datagen.depth import f32_reciprocal

#: Frames a clip's rank pool scatters at once (bounds the occupancy
#: buffer: V clips x FRAME_BLOCK x 2 grids).
FRAME_BLOCK = 8


def rank_coefficients(n_frame: Union[int, torch.Tensor], max_frames: int,
                      num_splits: int = 5) -> torch.Tensor:
    """(..., M, F_max) coefficients for clip lengths ``n_frame`` (an int
    or a tensor of any shape ...): column f holds each channel's rank
    weight of frame f, zero outside the channel's window or past n_frame.
    Channel 0: 2f - n + 1; channel m in 1..4: windows [round(n(m-1)/5),
    round(n(m+1)/5)) (the last ending at n), weight 2 idx - len + 1.
    ``torch.round`` rounds half to even, as numpy and jnp do."""
    n = torch.as_tensor(n_frame).to(torch.float32)[..., None]
    f = torch.arange(max_frames, dtype=torch.float32, device=n.device)
    in_clip = f < n
    zero = torch.zeros((), device=n.device)

    def window(lo, hi):
        w = 2.0 * (f - lo) - (hi - lo) + 1.0
        return torch.where((f >= lo) & (f < hi) & in_clip, w, zero)

    rows = [torch.where(in_clip, 2.0 * f - n + 1.0, zero)]
    for m in range(1, num_splits):
        lo = torch.round(n * (m - 1) / 5.0)
        hi = n if m == num_splits - 1 else torch.round(n * (m + 1) / 5.0)
        rows.append(window(lo, hi))
    return torch.stack(rows, dim=-2)


def voxel_indices(points: torch.Tensor, valid: torch.Tensor,
                  origin: torch.Tensor, voxel_size: float,
                  grid_shape: Tuple[int, int, int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Points (..., P, 3) -> clamped voxel indices ((..., P, 3) int64,
    valid and in range). ``origin`` (..., 3) broadcasts over P; the
    division by ``voxel_size`` is the product :func:`f32_reciprocal`
    says."""
    idx = torch.floor((points - origin[..., None, :]) *
                      f32_reciprocal(voxel_size)).long()
    limits = torch.tensor(grid_shape, device=points.device) - 1
    in_range = ((idx >= 0) & (idx <= limits)).all(-1)
    return torch.minimum(idx.clamp_min(0), limits), valid & in_range


def _flat(idx: torch.Tensor, grid_shape) -> torch.Tensor:
    return (idx[..., 0] * grid_shape[1] + idx[..., 1]) * grid_shape[2] + \
        idx[..., 2]


def scatter_occupancy(idx: torch.Tensor, valid: torch.Tensor,
                      grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Binary occupancy grid (..., X, Y, Z) from indices (..., P, 3): a
    scatter-max of the valid flags (repeated voxels dedupe)."""
    lead = idx.shape[:-2]
    n = grid_shape[0] * grid_shape[1] * grid_shape[2]
    occ = torch.zeros(*lead, n, device=idx.device)
    occ.scatter_reduce_(-1, _flat(idx, grid_shape), valid.float(), "amax")
    return occ.reshape(*lead, *grid_shape)


def rank_pool(frames_pts: torch.Tensor, frames_valid: torch.Tensor,
              key_pts: torch.Tensor, key_valid: torch.Tensor,
              n_frame: Union[int, torch.Tensor], origin: torch.Tensor,
              cfg: DatagenConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The M-channel 3DV grid and the key grid of a clip, or of V clips
    with a leading axis on every argument.

    frames_pts, key_pts: ([V,] F, P, 3) back-projected full-depth and
    motion-located points a frame; *_valid ([V,] F, P). Returns
    (voxel_di ([V,] M, X, Y, Z), voxel_key ([V,] X, Y, Z))."""
    single = frames_pts.dim() == 3
    if single:
        frames_pts, frames_valid, key_pts, key_valid, origin = (
            t[None] for t in (frames_pts, frames_valid, key_pts, key_valid,
                              origin))
    V, F = frames_pts.shape[:2]
    M, gs = cfg.num_splits, cfg.grid_shape
    nvox = gs[0] * gs[1] * gs[2]
    dev = frames_pts.device
    n = torch.as_tensor(n_frame, device=dev).reshape(-1).expand(V)
    coef = rank_coefficients(n, F, M)                         # (V, M, F)
    f = torch.arange(F, dtype=torch.float32, device=dev)
    nf = n.to(torch.float32)[:, None]
    coef_key = torch.where(f < nf, 2.0 * f - nf + 1.0,
                           torch.zeros((), device=dev))       # (V, F)
    di = torch.zeros(V, M, nvox, device=dev)
    dk = torch.zeros(V, 1, nvox, device=dev)
    for f0 in range(0, F, FRAME_BLOCK):
        f1 = min(F, f0 + FRAME_BLOCK)
        idx, v = voxel_indices(frames_pts[:, f0:f1], frames_valid[:, f0:f1],
                               origin[:, None], cfg.voxel_size, gs)
        kidx, kv = voxel_indices(key_pts[:, f0:f1], key_valid[:, f0:f1],
                                 origin[:, None], cfg.voxel_size, gs)
        # (V, fb, 2, P): plane 0 a frame's raw points, plane 1 its key
        # points; one scatter-max fills both planes of every frame.
        flat = torch.stack([_flat(idx, gs), _flat(kidx, gs)], dim=2)
        vals = torch.stack([v, kv], dim=2).float()
        occ = torch.zeros(V, f1 - f0, 2, nvox, device=dev)
        occ.scatter_reduce_(-1, flat, vals, "amax")
        di += torch.bmm(coef[:, :, f0:f1], occ[:, :, 0])
        dk += torch.bmm(coef_key[:, None, f0:f1], occ[:, :, 1])
    di = di.reshape(V, M, *gs)
    dk = dk.reshape(V, *gs)
    return (di[0], dk[0]) if single else (di, dk)


def denoise(grid: torch.Tensor, threshold: int) -> torch.Tensor:
    """3^3 neighbour-count denoise of (..., X, Y, Z) grids: a voxel stays
    if the occupied cells of its 27 (itself included) reach
    ``threshold``; border voxels always go (the reference writes counts
    to the interior only)."""
    occ = (grid != 0).to(torch.float32)
    c = occ[..., :-2, :, :] + occ[..., 1:-1, :, :] + occ[..., 2:, :, :]
    c = c[..., :, :-2, :] + c[..., :, 1:-1, :] + c[..., :, 2:, :]
    c = c[..., :, :, :-2] + c[..., :, :, 1:-1] + c[..., :, :, 2:]
    counts = torch.nn.functional.pad(c, (1, 1, 1, 1, 1, 1))
    keep = (counts >= threshold) & (occ > 0)
    return torch.where(keep, grid, torch.zeros_like(grid))
