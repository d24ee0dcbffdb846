"""The 10-crop augmentation factory (counterpart of
facl_tpu/data/crops.py), batched over videos on the batch's device.

Crop order (the reference's, cn3D_data_set.py:285-350; the circle loss
permutes over it and the extractor concatenates in it):
  0 raw        random 512-subset of the raw 3DV points
  1 rev        random subset -> jitter -> x-mirror + jitter
  2 key1       random subset of key points -> jitter
  3 key2       random subset of key points -> jitter -> x-mirror + jitter
  4 rot1       random subset -> jitter -> random y-rotation
  5 rot2       random subset -> jitter -> random y-rotation
  6 ti1        temporal view: xyz + channel 4, sampled where nonzero
  7 ti2        temporal view: xyz + channel 7, sampled where nonzero
  8 res30      random subset of the Resolution30 points
  9 res10      random subset of the Resolution10 points

Every crop carries 4 channels (xyz + channel 3). Each video draws its
own subsets, jitter and angles from one ``torch.Generator`` on the
device, in one batched call per transform (no loop over videos).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from facl_tpu_torch.config import DataConfig
from facl_tpu_torch.ops import transforms as T


class ClipSources(NamedTuple):
    """Stored clouds feeding the crop factory, each with a leading batch
    dim (B, N, C) in the batched functions.

    points / key_points: (N, >=4); for the motion stream the (2048, 8) 3DV
    clouds, for appearance the flattened per-frame sets (10 x 2048, 4).
    temporal_source: (N, >=8) cloud giving channels 4 and 7 for ti1/ti2
    (the raw 3DV cloud in both streams). res30 / res10: (N, >=4)."""
    points: torch.Tensor
    key_points: torch.Tensor
    temporal_source: torch.Tensor
    res30: torch.Tensor
    res10: torch.Tensor


def _crops(g: torch.Generator, src: ClipSources, num_points: int,
           jitter_sigma: float, jitter_clip: float, rotate_range: float,
           temporal_channels: Sequence[int]) -> torch.Tensor:
    """(B, 10, num_points, 4) from batched sources."""
    p4, k4 = src.points[..., :4], src.key_points[..., :4]

    def sub(pts):
        return T.resample(g, pts, num_points)

    def jit1(pts):
        return T.jitter(g, pts, jitter_sigma, jitter_clip)

    def rev(pts):
        return T.reverse_transform(g, pts, jitter_sigma, jitter_clip)

    raw = sub(p4)
    rv = rev(jit1(sub(p4)))
    ke1 = jit1(sub(k4))
    ke2 = rev(jit1(sub(k4)))
    ro1 = T.rotate_y_random(g, jit1(sub(p4)), rotate_range)
    ro2 = T.rotate_y_random(g, jit1(sub(p4)), rotate_range)
    ti1 = T.temporal_channel_view(g, src.temporal_source,
                                  temporal_channels[0], num_points)
    ti2 = T.temporal_channel_view(g, src.temporal_source,
                                  temporal_channels[1], num_points)
    rs1 = sub(src.res30[..., :4])
    rs2 = sub(src.res10[..., :4])
    return torch.stack([raw, rv, ke1, ke2, ro1, ro2, ti1, ti2, rs1, rs2],
                       dim=1)


def make_crops(g: torch.Generator, src: ClipSources, num_points: int = 512,
               jitter_sigma: float = 0.01, jitter_clip: float = 0.05,
               rotate_range: float = 0.8,
               temporal_channels: Sequence[int] = (4, 7)) -> torch.Tensor:
    """The (10, num_points, 4) crop tensor of one video (unbatched
    sources)."""
    batched = ClipSources(*(f[None] for f in src))
    return _crops(g, batched, num_points, jitter_sigma, jitter_clip,
                  rotate_range, temporal_channels)[0]


def make_crops_batch(g: torch.Generator, srcs: ClipSources,
                     cfg: DataConfig) -> torch.Tensor:
    """Batched crop factory: (10, B, num_points, 4), crop-major, ready
    for the train and eval steps."""
    crops = _crops(g, srcs, cfg.num_points, cfg.jitter_sigma,
                   cfg.jitter_clip, cfg.rotate_range,
                   tuple(cfg.temporal_channels))
    return crops.transpose(0, 1)


def random_augment(g: torch.Generator, points: torch.Tensor,
                   jitter_sigma: float = 0.01, jitter_clip: float = 0.05
                   ) -> torch.Tensor:
    """The legacy SimCLR-style augmentation (``get_random_augment``,
    cn3d_data_load.py:156-168) on (B, N, C): y rotation by angle_set *
    pi/4 with angle_set ~ U[-1.5, 1.5), xyz scale ~ U[0.6, 1.4), an
    x-mirror (+ jitter) with probability 1/2, then jitter. As in
    facl_tpu/data/crops.py:119-122, one coin decides the mirror for the
    whole batch."""
    B, dev = points.shape[0], points.device
    angle_set = -1.5 + 3.0 * torch.rand(B, generator=g, device=dev)
    out = T._rotate(points, T._rot_y(angle_set * math.pi * 0.25))
    scale = 0.6 + 0.8 * torch.rand(B, 1, 1, generator=g, device=dev)
    out = T._with_xyz(out, out[..., :3] * scale)
    mirrored = T.reverse_transform(g, out, jitter_sigma, jitter_clip)
    flip = torch.rand((), generator=g, device=dev) < 0.5
    out = torch.where(flip, mirrored, out)
    return T.jitter(g, out, jitter_sigma, jitter_clip)


def make_simclr_crops(g: torch.Generator, src: ClipSources,
                      num_points: int = 512) -> torch.Tensor:
    """Two-view SimCLR crops (``deal_data_simclr``,
    cn3d_data_load.py:42-78) of one video: two of the base views {raw,
    key, ti1, ti2} picked at random with replacement, each randomly
    augmented. Returns (2, num_points, 4)."""
    b = ClipSources(*(f[None] for f in src))
    base = torch.cat([
        T.resample(g, b.points[..., :4], num_points),
        T.resample(g, b.key_points[..., :4], num_points),
        T.temporal_channel_view(g, b.temporal_source, 4, num_points),
        T.temporal_channel_view(g, b.temporal_source, 7, num_points)])
    pick = torch.randint(0, 4, (2,), generator=g, device=base.device)
    v1 = random_augment(g, base[pick[0]][None])
    v2 = random_augment(g, base[pick[1]][None])
    return torch.cat([v1, v2])
