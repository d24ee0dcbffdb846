"""Voxel grids -> fixed-size point sets, sampling and normalisation
(counterpart of facl_tpu/datagen/pointize.py:25-126; generate_NTU.py:
196-260).

Candidates are the voxels nonzero in any channel. Sampling keeps every
candidate once and tops up with uniform random repeats when there are at
most S, else draws S uniformly with replacement. The draw is one call of
``randint(n, shape)``, a function the caller passes in that returns
integers in [0, n) on the grid's device, made on every call whichever
branch is taken, so a clip's stream of draws does not depend on its
data. xyz is centred on the sampled raw cloud's bounding-box midpoint and
divided by its y extent; the motion channels are min-max normalised to
[-0.5, 0.5] by the raw cloud's extents, which also normalise the key and
appearance sets.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from facl_tpu_torch.datagen.depth import f32_reciprocal

#: ``randint(n, shape)`` -> int64 tensor of draws in [0, n).
RandInt = Callable[[int, Tuple[int, ...]], torch.Tensor]


def _take_or_pad(randint: RandInt, flat_ids: torch.Tensor,
                 n_valid: torch.Tensor, sample_num: int) -> torch.Tensor:
    """``sample_num`` of the first ``n_valid`` entries of ``flat_ids``:
    all of them then random extras when n_valid <= sample_num, else
    uniform with replacement."""
    n = int(n_valid)
    rand = randint(max(n, 1), (sample_num,)).to(flat_ids.device)
    seq = torch.arange(sample_num, device=flat_ids.device)
    return flat_ids[torch.where((seq < n) & (n <= sample_num), seq, rand)]


def compact_nonzero(mask_flat: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The indices of the nonzero entries of (V,) ``mask_flat``, in order,
    at the front of a (V,) int64 vector (zeros after), and their count
    (a 0-d tensor): a cumsum and a scatter."""
    V = mask_flat.shape[-1]
    m = mask_flat.to(torch.int64)
    rank = torch.cumsum(m, -1) - 1
    pos = torch.arange(V, device=m.device).expand_as(m)
    # Each nonzero entry writes its position to its rank; the others to a
    # dump slot V that is cut off.
    buf = torch.zeros(*m.shape[:-1], V + 1, dtype=torch.int64,
                      device=m.device)
    buf.scatter_(-1, torch.where(m > 0, rank, V), pos)
    return buf[..., :V], m.sum(-1)


def voxels_to_points(randint: RandInt, di: torch.Tensor, sample_num: int,
                     select_mask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, X, Y, Z) grid -> (S, 3+M) sampled points (voxel coordinates and
    the M motion channels) and the candidate count. ``select_mask``
    (X, Y, Z) bool restricts the candidates (the key set: key-occupied
    voxels, motion values read from the raw grid)."""
    M, gs = di.shape[0], di.shape[1:]
    flat = di.reshape(M, -1)
    nz = (flat != 0).any(0)
    if select_mask is not None:
        nz = nz & select_mask.reshape(-1)
    ids, n_valid = compact_nonzero(nz)
    chosen = _take_or_pad(randint, ids, n_valid, sample_num)
    zi = chosen % gs[2]
    yi = (chosen // gs[2]) % gs[1]
    xi = chosen // (gs[1] * gs[2])
    coords = torch.stack([xi, yi, zi], dim=-1).to(torch.float32)
    return torch.cat([coords, flat[:, chosen].T], dim=-1), n_valid


def normalization_stats(points: torch.Tensor):
    """(centers (3,), y_len (), c_min (M,), c_len (M,)) of a sampled raw
    cloud (S, 3+M)."""
    xyz = points[:, :3]
    mx, mn = xyz.amax(0), xyz.amin(0)
    centers = (mx + mn) / 2.0
    y_len = (mx[1] - mn[1]).clamp_min(1e-6)
    c = points[:, 3:]
    c_min = c.amin(0)
    c_len = (c.amax(0) - c_min).clamp_min(1e-6)
    return centers, y_len, c_min, c_len


def apply_normalization(points: torch.Tensor, centers: torch.Tensor,
                        y_len: torch.Tensor, c_min: torch.Tensor,
                        c_len: torch.Tensor) -> torch.Tensor:
    """xyz -> (xyz - centers) / y_len; channels -> min-max - 0.5."""
    xyz = (points[:, :3] - centers[None, :]) / y_len
    c = (points[:, 3:] - c_min[None, :]) / c_len[None, :] - 0.5
    return torch.cat([xyz, c], dim=-1)


def appearance_frame(randint: RandInt, pts: torch.Tensor,
                     valid: torch.Tensor, origin: torch.Tensor,
                     voxel_size: float, di0: torch.Tensor,
                     sample_num: int) -> torch.Tensor:
    """One frame's appearance set (generate_NTU.py:49-74): every valid
    pixel's continuous voxel-space coordinates and channel 0 of the 3DV
    grid at its voxel, resampled to ``sample_num`` by the keep-all rule.
    Returns (sample_num, 4), not normalised. Dividing by ``voxel_size``
    is the product :func:`f32_reciprocal` says."""
    gs = di0.shape
    vox = (pts - origin[None, :]) * f32_reciprocal(voxel_size)
    limits = torch.tensor(gs, device=pts.device) - 1
    idx = torch.minimum(torch.floor(vox).long().clamp_min(0), limits)
    motion = di0[idx[:, 0], idx[:, 1], idx[:, 2]]
    feat = torch.cat([vox, motion[:, None]], dim=-1)
    ids, n_valid = compact_nonzero(valid)
    return feat[_take_or_pad(randint, ids, n_valid, sample_num)]
