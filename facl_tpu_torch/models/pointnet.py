"""Set-abstraction point encoder (counterpart of
facl_tpu/models/pointnet.py).

Rows are BATCH-major: crop g of video b sits at row b*G + g
(pointnet.py:14-35), so the global branch — a joint max over all G crops
of a video — is a pure reshape. The embed head is shared by the local and
the global branch, so in train mode its BatchNorm running statistics
update twice per step, local before global (pointnet.py:111-112).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from facl_tpu_torch.config import Config, GroupingConfig, ModelConfig
from facl_tpu_torch.models.layers import EmbedHead, PointMLP, dense, \
    l2_normalize
from facl_tpu_torch.models.sa_stage import SetAbstractionStage
from facl_tpu_torch.ops._launch import TRUNK

#: sa_impl values the port accepts: every value of the JAX package.
#: "auto" resolves to "pair3" where the sweep kernels take the widths, else
#: to "reference" (resolve_model_config).
SA_IMPLS = ("auto", "reference", "covar", "analytic", "hybrid", "hybrid2",
            "pair", "pair3", "pallas")


class PointNetPlus(nn.Module):
    """Single-level set-abstraction encoder with local + global heads."""

    def __init__(self, cfg: ModelConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg = resolve_model_config(cfg)
        self.sa_stage = SetAbstractionStage(
            cfg.in_features, cfg.sa_widths, cfg.bn_momentum,
            channels_first=cfg.channels_first, impl=cfg.sa_impl,
            generator=generator)
        self.stage2_mlp = PointMLP(3 + cfg.sa_widths[-1], cfg.stage2_widths,
                                   cfg.bn_momentum, generator=generator)
        self.head = EmbedHead(cfg.stage2_widths[-1], cfg.fc_hidden,
                              cfg.embed_dim, cfg.bn_momentum,
                              generator=generator)
        # Prototype scores; no bias (cn3d_model_conbag.py:91).
        self.mapping = dense(cfg.embed_dim, cfg.num_prototypes, bias=False,
                             generator=generator)

    def forward(self, neighborhoods: torch.Tensor, centers: torch.Tensor
                ) -> Tuple[torch.Tensor, ...]:
        """Returns (x (B*G, D), code (B*G, P), x_nor (B*G, D),
        x_global (B, D)); train or eval by ``self.training``."""
        G = self.cfg.num_crops
        if self.cfg.channels_first:
            GB, C, S, K = neighborhoods.shape
        else:
            GB, S, K, C = neighborhoods.shape
        if C != self.cfg.in_features:
            raise ValueError(
                f"encoder configured for in_features={self.cfg.in_features} "
                f"but got {C}-channel neighborhoods")
        B = GB // G
        h = self.sa_stage(neighborhoods)                        # (GB, S, C3)
        h = torch.cat([centers.to(h.dtype), h], dim=-1)
        local = self.stage2_mlp(h)                              # (GB, S, F)
        x = local.amax(1)
        x_global = local.reshape(B, G * S, local.shape[-1]).amax(1)
        x = self.head(x)
        x_global = self.head(x_global)
        x_nor = l2_normalize(x, dim=1)
        return x, self.mapping(x_nor), x_nor, x_global


def resolve_model_config(model_cfg: ModelConfig) -> ModelConfig:
    """Resolve ``sa_impl="auto"`` and ``channels_first=None``.

    "auto" is "pair3" where its kernels take the stage: SA widths
    ``TRUNK`` (64, 64, 256) and at most 7 input channels (the sweeps'
    C0 limit). Any other stage resolves to "reference", the JAX package's
    choice off the TPU (facl_tpu/models/pointnet.py:161-170), so "auto"
    then gives the JAX result. ``channels_first=None`` becomes True
    exactly for "pair"/"pair3", the impls that read the channel-major
    layout of kernel B1 (facl_tpu/models/pointnet.py:171-173). An
    explicit ``sa_impl`` is honoured."""
    impl = model_cfg.sa_impl
    if impl not in SA_IMPLS:
        raise ValueError(f"unknown sa_impl {impl!r}; expected one of "
                         f"{SA_IMPLS}")
    if impl == "auto":
        fits = tuple(model_cfg.sa_widths) == TRUNK and \
            model_cfg.in_features <= 7
        impl = "pair3" if fits else "reference"
    cf = model_cfg.channels_first
    if cf is None:
        cf = impl in ("pair", "pair3")
    return dataclasses.replace(model_cfg, sa_impl=impl, channels_first=cf)


def resolve_grouping(cfg: Config) -> GroupingConfig:
    """The grouping ``cfg.model.name`` runs with. The 'fine' variant
    differs only in grouping (S=32, K=128, cn3d_model_conbag.py:141-234).
    """
    name = cfg.model.name
    if name == "pointnet_plus":
        return cfg.grouping
    if name == "pointnet_plus_fine":
        return dataclasses.replace(
            cfg.grouping, num_centroids=cfg.model.fine_num_centroids,
            knn_k=cfg.model.fine_knn_k)
    if name == "slow_fast":
        raise NotImplementedError("slow_fast is not ported yet (ROADMAP "
                                  "Queue 1 item 15)")
    raise ValueError(f"unknown model name {name!r}; expected pointnet_plus, "
                     "pointnet_plus_fine or slow_fast")


def resolve_model(cfg: Config, generator: Optional[torch.Generator] = None
                  ) -> Tuple[PointNetPlus, GroupingConfig]:
    """Encoder + effective grouping from ``cfg.model.name``. Parameters
    are made on the CPU from ``generator``; move the module to its device
    afterwards."""
    g = resolve_grouping(cfg)
    return PointNetPlus(cfg.model, generator), g
