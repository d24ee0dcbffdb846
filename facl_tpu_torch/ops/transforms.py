"""Point-cloud augmentation transforms (counterpart of
facl_tpu/ops/transforms.py).

Every function takes a batch ``(B, N, C)`` (xyz in channels 0:3, the other
channels kept unless stated) on any device and returns a new tensor. The
random ones draw from an explicit ``torch.Generator`` on the batch's
device, independently per cloud: the JAX package vmaps its crop factory
over videos (facl_tpu/data/crops.py:152), so each video gets its own
draw there too. torch and JAX draw different numbers; the distributions
and the arithmetic are the same.

Where ``g`` is a :class:`BatchRows`, each draw is that of a larger batch
sliced to this one's rows: a data-parallel rank that holds some videos of
a global batch then draws, for each, what one process holding the whole
batch draws (data/dataset.py::CropLoader with a mesh).
"""
from __future__ import annotations

import math

import torch


class BatchRows:
    """A generator for some rows of a larger batch: every draw is made at
    the shape of the full ``batch`` from ``generator`` (so the generator
    advances as for the full batch), then ``rows`` (a LongTensor of
    positions in it, on the draw's device) are kept."""

    def __init__(self, generator: torch.Generator, batch: int,
                 rows: torch.Tensor):
        self.generator, self.batch, self.rows = generator, batch, rows


def _draw(g, sample, shape, device, **kw) -> torch.Tensor:
    """``sample(shape, generator=, device=)`` of a batch-leading shape,
    through ``BatchRows`` where ``g`` is one."""
    if isinstance(g, BatchRows):
        full = sample((g.batch, *shape[1:]), generator=g.generator,
                      device=device, **kw)
        return full[g.rows]
    return sample(tuple(shape), generator=g, device=device, **kw)


def _rot_y(angle: torch.Tensor) -> torch.Tensor:
    """(B,) angles -> (B, 3, 3) y-axis rotations for row vectors (p @ R)."""
    c, s = torch.cos(angle), torch.sin(angle)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1),
                        torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], dim=-2)


def _with_xyz(points: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    return torch.cat([xyz, points[..., 3:]], dim=-1)


def _rotate(points: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    return _with_xyz(points, torch.einsum("bnd,bde->bne", points[..., :3], R))


def _uniform(g: torch.Generator, shape, low: float, high: float,
             device) -> torch.Tensor:
    return low + (high - low) * _draw(g, torch.rand, shape, device)


def jitter(g: torch.Generator, points: torch.Tensor, sigma: float = 0.01,
           clip: float = 0.05) -> torch.Tensor:
    """Per-point gaussian xyz jitter, clipped to +-clip."""
    noise = (sigma * _draw(g, torch.randn, points[..., :3].shape,
                           points.device)).clamp(-clip, clip)
    return _with_xyz(points, points[..., :3] + noise)


def mirror_x(points: torch.Tensor) -> torch.Tensor:
    """Negate x."""
    return torch.cat([-points[..., :1], points[..., 1:]], dim=-1)


def reverse_transform(g: torch.Generator, points: torch.Tensor,
                      sigma: float = 0.01, clip: float = 0.05
                      ) -> torch.Tensor:
    """x-mirror, then jitter (the reference jitters after negating x)."""
    return jitter(g, mirror_x(points), sigma, clip)


def rotate_y_random(g: torch.Generator, points: torch.Tensor,
                    rotate_range: float = 0.8) -> torch.Tensor:
    """Per-cloud y rotation by (U - 0.5) * pi * rotate_range."""
    u = _draw(g, torch.rand, points.shape[:1], points.device)
    return _rotate(points, _rot_y((u - 0.5) * math.pi * rotate_range))


def rotate_y_fixed(points: torch.Tensor, angle_set: float) -> torch.Tensor:
    """y rotation by angle_set * pi / 4."""
    angle = torch.full((points.shape[0],), angle_set * math.pi * 0.25,
                       device=points.device)
    return _rotate(points, _rot_y(angle))


def rotate_y_uniform(g: torch.Generator, points: torch.Tensor
                     ) -> torch.Tensor:
    """Per-cloud y rotation by U[0, 2 pi)."""
    u = _draw(g, torch.rand, points.shape[:1], points.device)
    return _rotate(points, _rot_y(u * 2.0 * math.pi))


def rotate_perturbation(g: torch.Generator, points: torch.Tensor,
                        angle_sigma: float = 0.06,
                        angle_clip: float = 0.18) -> torch.Tensor:
    """Small random rotations about x, y and z, R = Rz @ Ry @ Rx."""
    B, dev = points.shape[0], points.device
    ang = (angle_sigma * _draw(g, torch.randn, (B, 3), dev)).clamp(
        -angle_clip, angle_clip)
    c, s = torch.cos(ang), torch.sin(ang)
    z, o = torch.zeros(B, device=dev), torch.ones(B, device=dev)
    Rx = torch.stack([torch.stack([o, z, z], -1),
                      torch.stack([z, c[:, 0], -s[:, 0]], -1),
                      torch.stack([z, s[:, 0], c[:, 0]], -1)], -2)
    Ry = torch.stack([torch.stack([c[:, 1], z, s[:, 1]], -1),
                      torch.stack([z, o, z], -1),
                      torch.stack([-s[:, 1], z, c[:, 1]], -1)], -2)
    Rz = torch.stack([torch.stack([c[:, 2], -s[:, 2], z], -1),
                      torch.stack([s[:, 2], c[:, 2], z], -1),
                      torch.stack([z, z, o], -1)], -2)
    return _rotate(points, Rz @ Ry @ Rx)


def scale_random(g: torch.Generator, points: torch.Tensor, low: float = 0.5,
                 high: float = 1.5) -> torch.Tensor:
    """Per-cloud uniform xyz scale in [low, high)."""
    s = _uniform(g, (points.shape[0], 1, 1), low, high, points.device)
    return _with_xyz(points, points[..., :3] * s)


def shift_random(g: torch.Generator, points: torch.Tensor,
                 shift_range: float = 0.1) -> torch.Tensor:
    """Per-cloud uniform xyz translation in [-shift_range, shift_range)."""
    t = _uniform(g, (points.shape[0], 1, 3), -shift_range, shift_range,
                 points.device)
    return _with_xyz(points, points[..., :3] + t)


def rank_transform(points: torch.Tensor, rank_slope: float = -1.0
                   ) -> torch.Tensor:
    """Scale xyz by a constant."""
    return _with_xyz(points, points[..., :3] * rank_slope)


def motion_rescale(g: torch.Generator, points: torch.Tensor) -> torch.Tensor:
    """Scale the channels past xyz by s ~ U[0.2, 0.9) per cloud."""
    s = _uniform(g, (points.shape[0], 1, 1), 0.2, 0.9, points.device)
    return torch.cat([points[..., :3], points[..., 3:] * s], dim=-1)


def normalize_xyz(points: torch.Tensor) -> torch.Tensor:
    """Centre xyz at the bounding box's midpoint, divide by the y extent."""
    xyz = points[..., :3]
    mx = xyz.amax(dim=-2, keepdim=True)
    mn = xyz.amin(dim=-2, keepdim=True)
    return _with_xyz(points, (xyz - (mx + mn) / 2.0) / (mx - mn)[..., 1:2])


def _take(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (B, M) of each cloud of ``points`` (B, N, C)."""
    return torch.gather(points, 1,
                        idx[..., None].expand(-1, -1, points.shape[-1]))


def resample(g: torch.Generator, points: torch.Tensor, num_out: int
             ) -> torch.Tensor:
    """``num_out`` rows of each cloud, uniformly with replacement."""
    B, N = points.shape[:2]
    idx = _draw(g, lambda shape, **kw: torch.randint(0, N, shape, **kw),
                (B, num_out), points.device)
    return _take(points, idx)


def masked_resample(g: torch.Generator, points: torch.Tensor,
                    mask: torch.Tensor, num_out: int) -> torch.Tensor:
    """``num_out`` rows of each cloud, uniformly with replacement among
    the rows where ``mask`` (B, N) is set; a cloud with no such row draws
    from all its rows (facl_tpu/ops/transforms.py:164-180).

    Draw r uniform in [0, count) and take the (r+1)-th set row: the
    first row whose running count of set rows exceeds r. No categorical
    draw, so an all-zero mask neither raises nor loses its cloud."""
    B, N = mask.shape
    keep = mask > 0
    keep = torch.where(keep.any(-1, keepdim=True), keep,
                       torch.ones_like(keep))
    cum = keep.to(torch.int64).cumsum(-1)                      # (B, N)
    count = cum[:, -1:]
    u = _draw(g, torch.rand, (B, num_out), points.device,
              dtype=torch.float64)
    r = torch.minimum((u * count).to(torch.int64), count - 1)
    idx = torch.searchsorted(cum, r, right=True)
    return _take(points, idx)


def temporal_channel_view(g: torch.Generator, points: torch.Tensor,
                          channel: int, num_out: int) -> torch.Tensor:
    """xyz + one motion channel, sampled from the rows where that channel
    is nonzero."""
    feat = torch.cat([points[..., :3], points[..., channel:channel + 1]],
                     dim=-1)
    return masked_resample(g, feat, feat[..., 3].abs() > 0, num_out)
