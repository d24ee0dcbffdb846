"""Two-pathway (SlowFast-style) point encoder (counterpart of
facl_tpu/models/slowfast.py).

A slow branch over wide neighbourhoods (K=128 in the trainer) and a fast
branch over narrow ones (K=64), each a shared MLP pooled over its
neighbours, fused by 1x1-conv laterals concatenated along the group axis,
a second MLP pooled over the groups, and an embed head per branch. No SA
kernel runs here: the MLPs are plain Dense/BatchNorm/ReLU, as in JAX
(facl_tpu/models/slowfast.py:36-61); grouping (kernel B1) is the
trainer's.

Submodule names are JAX's (``slow1``, ``fast1``, ``slow_to_fast``,
``fast_to_slow``, ``slow3``, ``fast3``, ``head_slow``, ``head_fast``), so
``convert.from_jax`` carries the variables unchanged.
``compute_dtype`` "bfloat16" casts the neighbourhoods to bf16 and runs
every layer in bf16 (layers.py); the embeddings come back f32. With a
data-parallel ``mesh`` the BatchNorm statistics are over every rank's
rows; with ``mp > 1`` the Denses of 512 output columns or more (slow3's
256->512, fast3's 256->512 and 512->1024, both heads at ``fc_hidden``
1024) hold their column block (layers.py::ColumnDense).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from facl_tpu_torch.config import ModelConfig
from facl_tpu_torch.models.layers import EmbedHead, PointMLP, apply_dense, \
    dense
from facl_tpu_torch.models.pointnet import compute_dtype


class PointNetSlowFast(nn.Module):
    """slow (B, S, K_slow, C), fast (B, S, K_fast, C) -> (x_fast, x_slow),
    each (B, embed_dim) f32; train or eval by ``self.training``."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype = compute_dtype(cfg)
        mom = cfg.bn_momentum
        s1, s3 = tuple(cfg.slow_widths1), tuple(cfg.slow_widths3)
        f1, f3 = tuple(cfg.fast_widths1), tuple(cfg.fast_widths3)

        def mlp(cin, widths):
            return PointMLP(cin, widths, mom, generator=generator,
                            dtype=dtype, mesh=mesh)

        def head(cin):
            return EmbedHead(cin, cfg.fc_hidden, cfg.embed_dim, mom,
                             generator=generator, dtype=dtype, mesh=mesh)
        self.slow1 = mlp(cfg.in_features, s1)
        self.fast1 = mlp(cfg.in_features, f1)
        self.slow_to_fast = dense(s1[-1], f1[-1], generator=generator,
                                  mesh=mesh)
        self.fast_to_slow = dense(f1[-1], s1[-1], generator=generator,
                                  mesh=mesh)
        self.slow3 = mlp(s1[-1], s3)
        self.fast3 = mlp(f1[-1], f3)
        self.head_slow = head(s3[-1])
        self.head_fast = head(f3[-1])

    def forward(self, slow_neigh: torch.Tensor, fast_neigh: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        for name, t in (("slow", slow_neigh), ("fast", fast_neigh)):
            if t.ndim != 4 or t.shape[-1] != self.cfg.in_features:
                raise ValueError(
                    f"{name} neighbourhoods: expected (B, S, K, "
                    f"{self.cfg.in_features}), got {tuple(t.shape)}")
        dt = self.dtype
        h_slow = self.slow1(slow_neigh.to(dt)).amax(2)          # (B, S, .)
        h_fast = self.fast1(fast_neigh.to(dt)).amax(2)
        s2f = apply_dense(self.slow_to_fast, h_slow, dt)
        f2s = apply_dense(self.fast_to_slow, h_fast, dt)
        h_slow = torch.cat([h_slow, f2s], dim=1)                # (B, 2S, .)
        h_fast = torch.cat([h_fast, s2f], dim=1)
        h_slow = self.slow3(h_slow).amax(1)                     # (B, .)
        h_fast = self.fast3(h_fast).amax(1)
        x_slow = self.head_slow(h_slow)
        x_fast = self.head_fast(h_fast)
        return x_fast.float(), x_slow.float()
