"""Set-abstraction point encoder (counterpart of
facl_tpu/models/pointnet.py).

Rows are BATCH-major: crop g of video b sits at row b*G + g
(pointnet.py:14-35), so the global branch — a joint max over all G crops
of a video — is a pure reshape. The embed head is shared by the local and
the global branch, so in train mode its BatchNorm running statistics
update twice per step, local before global (pointnet.py:111-112).

``ModelConfig.compute_dtype`` "bfloat16" follows facl_tpu/models/
pointnet.py:97-117: the grouped neighbourhoods (grouping stays f32) and
the centers are cast to bf16, the SA stage, stage-2 MLP and head compute
in bf16, the head outputs are cast to f32, and the prototype mapping runs
in bf16 on the f32 ``x_nor`` and is cast to f32.

``mesh`` (data parallelism, facl_tpu/models/pointnet.py:55-67): the
encoder sees this rank's block of the batch; the SA stage, the stage-2
MLP and the head take their BatchNorm statistics over every rank's rows.
With ``mp > 1`` the Denses that JAX's rule splits (stage-2's 256->512 and
512->1024, the head's 1024->1024 and 1024->512 at bench.py's widths;
``mapping`` where it has 512 prototypes or more) hold their column block
(layers.py::ColumnDense); the SA stage is replicated over the mp ranks,
as JAX's ``shard_map`` over ``dp`` runs it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from facl_tpu_torch.config import Config, GroupingConfig, ModelConfig
from facl_tpu_torch.models.layers import EmbedHead, PointMLP, apply_dense, \
    dense, l2_normalize
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
                 generator: Optional[torch.Generator] = None, mesh=None):
        super().__init__()
        self.cfg = cfg = resolve_model_config(cfg)
        self.dtype = dtype = compute_dtype(cfg)
        self.sa_stage = SetAbstractionStage(
            cfg.in_features, cfg.sa_widths, cfg.bn_momentum,
            channels_first=cfg.channels_first, impl=cfg.sa_impl,
            generator=generator, dtype=dtype, mesh=mesh)
        self.stage2_mlp = PointMLP(3 + cfg.sa_widths[-1], cfg.stage2_widths,
                                   cfg.bn_momentum, generator=generator,
                                   dtype=dtype, mesh=mesh)
        self.head = EmbedHead(cfg.stage2_widths[-1], cfg.fc_hidden,
                              cfg.embed_dim, cfg.bn_momentum,
                              generator=generator, dtype=dtype, mesh=mesh)
        # Prototype scores; no bias (cn3d_model_conbag.py:91).
        self.mapping = dense(cfg.embed_dim, cfg.num_prototypes, bias=False,
                             generator=generator, mesh=mesh)

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
        bf = self.dtype == torch.bfloat16
        if bf:
            neighborhoods = neighborhoods.to(self.dtype)
        h = self.sa_stage(neighborhoods)                        # (GB, S, C3)
        h = torch.cat([centers.to(h.dtype), h], dim=-1)
        local = self.stage2_mlp(h)                              # (GB, S, F)
        x = local.amax(1)
        x_global = local.reshape(B, G * S, local.shape[-1]).amax(1)
        x = self.head(x)
        x_global = self.head(x_global)
        if bf:
            x, x_global = x.float(), x_global.float()
        x_nor = l2_normalize(x, dim=1)
        code = apply_dense(self.mapping, x_nor, self.dtype)
        return x, code.float() if bf else code, x_nor, x_global

    def local_grad_params(self):
        """The parameters whose train-mode gradients are this rank's share
        of the global loss, to be summed over the ranks: all of them, but
        the SA stage's where its backward already returns them global
        (``SetAbstractionStage.global_grads``: pair/pair3 and analytic
        under a mesh). Under ``mp > 1`` these are still summed over the
        dp group only: the mp ranks of one block compute the same rows
        (a split weight's block gradient, or a replicated parameter's
        gradient, alike on each)."""
        stage = set(map(id, self.sa_stage.parameters())) \
            if self.sa_stage.global_grads else set()
        return [p for p in self.parameters() if id(p) not in stage]


#: ModelConfig.compute_dtype values the port runs.
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(model_cfg: ModelConfig) -> torch.dtype:
    """The torch dtype of ``model_cfg.compute_dtype``."""
    name = model_cfg.compute_dtype
    if name not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"compute_dtype={name!r} is not ported; the port runs "
            f"{tuple(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


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
    ``slow_fast`` raises ValueError, as facl_tpu/models/pointnet.py:209-215
    does: it groups twice, in its own trainer."""
    name = cfg.model.name
    if name == "pointnet_plus":
        return cfg.grouping
    if name == "pointnet_plus_fine":
        return dataclasses.replace(
            cfg.grouping, num_centroids=cfg.model.fine_num_centroids,
            knn_k=cfg.model.fine_knn_k)
    if name == "slow_fast":
        raise ValueError(
            "model name 'slow_fast' has a two-pathway forward; use "
            "facl_tpu_torch.train.slowfast_trainer.SlowFastTrainer (the "
            "pretrain CLI dispatches automatically)")
    raise ValueError(f"unknown model name {name!r}; expected pointnet_plus, "
                     "pointnet_plus_fine or slow_fast")


def resolve_model(cfg: Config, generator: Optional[torch.Generator] = None,
                  mesh=None) -> Tuple[PointNetPlus, GroupingConfig]:
    """Encoder + effective grouping from ``cfg.model.name``. Parameters
    are made on the CPU from ``generator``; move the module to its device
    afterwards."""
    g = resolve_grouping(cfg)
    return PointNetPlus(cfg.model, generator, mesh), g
