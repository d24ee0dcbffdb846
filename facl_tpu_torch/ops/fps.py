"""Farthest point sampling (counterpart of facl_tpu/ops/fps.py).

Iterative max-min FPS, one distance update and argmax a step, batched
over clouds. The training path never calls it (crops are uniform random
subsets); it is the public op of the reference's ``fps_sample_data``.
The random first pick comes from an explicit generator, or is given.
"""
from __future__ import annotations

from typing import Optional

import torch


def _starts(B: int, N: int, starts, generator, device) -> torch.Tensor:
    if starts is None:
        starts = torch.randint(0, N, (B,), generator=generator)
    return torch.as_tensor(starts, dtype=torch.long).reshape(B).to(device)


def fps_batched(xyz: torch.Tensor, sample_num: int,
                starts: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
    """(B, N, 3) -> (B, S) int64 FPS indices. ``starts`` (B,): each
    cloud's first pick, drawn from ``generator`` (on the CPU) when not
    given. Among equal distances argmax takes the first."""
    B, N, _ = xyz.shape
    rows = torch.arange(B, device=xyz.device)

    def dist_to(i):
        d = xyz - xyz[rows, i][:, None]
        return (d * d).sum(-1)

    idx = torch.zeros(B, sample_num, dtype=torch.long, device=xyz.device)
    nxt = _starts(B, N, starts, generator, xyz.device)
    idx[:, 0] = nxt
    min_dist = dist_to(nxt)
    for s in range(1, sample_num):
        nxt = min_dist.argmax(-1)
        idx[:, s] = nxt
        min_dist = torch.minimum(min_dist, dist_to(nxt))
    return idx


def farthest_point_sampling(xyz: torch.Tensor, sample_num: int,
                            start: Optional[int] = None,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """FPS indices (S,) of one cloud (N, 3)."""
    return fps_batched(xyz[None], sample_num,
                       None if start is None else [start], generator)[0]


def fps_reorder(points: torch.Tensor, sample_num: int,
                starts: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
    """(B, N, C) -> (B, N, C): the S FPS picks first, in pick order, then
    the rest in their order (the reference's ``fps_sample_data``
    contract; grouping takes the first S rows as centroids)."""
    B, N, _ = points.shape
    idx = fps_batched(points[..., :3], sample_num, starts, generator)
    rank = torch.full((B, N), N, dtype=torch.long, device=points.device)
    rank.scatter_(1, idx, torch.arange(sample_num, device=points.device)
                  .expand(B, sample_num))
    pos = torch.arange(N, device=points.device).expand(B, N)
    perm = torch.where(rank < N, rank, N + pos).argsort(-1)
    return torch.gather(points, 1, perm[..., None].expand_as(points))
