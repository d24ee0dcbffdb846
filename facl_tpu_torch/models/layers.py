"""Shared building blocks for the point encoders (counterpart of
facl_tpu/models/layers.py).

BatchNorm follows flax's convention, not ``torch.nn.BatchNorm1d``'s:
statistics over every non-channel axis of a channels-last input, the
biased variance (E[x^2] - E[x]^2 clamped at 0) both for normalising and
for the running update ``m*old + (1-m)*new`` with m = 0.9. Parameter and
buffer names follow flax's (``scale``/``bias``, ``mean``/``var``) so that
``facl_tpu_torch.convert.from_jax`` maps variable trees one to one.

``dtype`` is the compute dtype, as flax's ``dtype=`` (facl_tpu/models/
layers.py): at ``torch.bfloat16`` a Dense multiplies in bf16 from its f32
parameters (f32 accumulation) and adds its bf16 bias to the bf16 product;
a BatchNorm takes its statistics over the f32 upcast, updates its running
buffers in f32, normalises in f32 and casts its output to bf16
(flax/linen/normalization.py ``_compute_stats`` / ``_normalize``).
Parameters and buffers stay f32.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from facl_tpu_torch.parallel.collectives import global_moments


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's default Dense init: truncated normal (+-2 std) with variance
    1/fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


def dense(cin: int, cout: int, bias: bool = True,
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """nn.Linear initialised like flax's nn.Dense (lecun-normal kernel,
    zero bias)."""
    lin = nn.Linear(cin, cout, bias=bias)
    w = torch.empty(cin, cout)
    lecun_normal_(w, cin, generator)
    with torch.no_grad():
        lin.weight.copy_(w.T)
        if bias:
            lin.bias.zero_()
    return lin


def apply_dense(lin: nn.Linear, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``lin(x)``; at bf16 as flax's ``nn.Dense(dtype=bfloat16)``: the
    product of the bf16 input and kernel (rounded once), plus the bf16
    bias."""
    if dtype != torch.bfloat16:
        return lin(x)
    y = nn.functional.linear(x.to(dtype), lin.weight.to(dtype))
    return y if lin.bias is None else y + lin.bias.to(dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the trailing channel axis, flax semantics. With a
    data-parallel ``mesh`` (parallel/mesh.py) the training statistics are
    over every rank's rows, as JAX's on a dp mesh (SyncBN semantics)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 mesh=None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.mesh = mesh
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bf = self.dtype == torch.bfloat16
        if bf:
            x = x.float()
        if self.training:
            mean, var = global_moments(x.reshape(-1, x.shape[-1]), self.mesh)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias
        return y.to(self.dtype) if bf else y


class PointMLP(nn.Module):
    """Stack of [Dense -> BatchNorm -> ReLU] over the trailing channel axis
    (the 1x1-conv shared MLP)."""

    def __init__(self, in_features: int, widths: Sequence[int],
                 bn_momentum: float = 0.9,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        self.n, self.dtype = len(widths), dtype
        cin = in_features
        for i, w in enumerate(widths):
            setattr(self, f"dense_{i}", dense(cin, w, generator=generator))
            setattr(self, f"BatchNorm_{i}",
                    BatchNorm(w, bn_momentum, dtype=dtype, mesh=mesh))
            cin = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = apply_dense(getattr(self, f"dense_{i}"), x, self.dtype)
            x = torch.relu(getattr(self, f"BatchNorm_{i}")(x))
        return x


class EmbedHead(nn.Module):
    """The reference's ``netR_FC``: Linear -> BN -> ReLU -> Linear
    (cn3d_model_conbag.py:82-88), shared by the local and global paths."""

    def __init__(self, in_features: int, hidden: int = 1024, out: int = 512,
                 bn_momentum: float = 0.9,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = dense(in_features, hidden, generator=generator)
        self.BatchNorm_0 = BatchNorm(hidden, bn_momentum, dtype=dtype,
                                     mesh=mesh)
        self.Dense_1 = dense(hidden, out, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.BatchNorm_0(apply_dense(self.Dense_0, x,
                                                    self.dtype)))
        return apply_dense(self.Dense_1, h, self.dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=2) semantics (clamped norm)."""
    return x / torch.linalg.vector_norm(x, dim=dim,
                                        keepdim=True).clamp_min(eps)
