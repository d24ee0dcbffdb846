"""Set-abstraction stage: [Dense -> BN -> ReLU] x L + max over neighbours
(counterpart of facl_tpu/models/sa_stage.py).

The stage owns its parameters directly — ``kernel_i`` (Cin, Cout),
``bias_i``, ``scale_i``, ``shift_i`` and the running buffers ``mean_i``,
``var_i``, named as in the JAX module (sa_stage.py:114-125), so one
``state_dict`` serves every ``impl``. Train mode dispatches on ``impl``
(sa_stage.py:133-220):

  reference, covar  plain torch, differentiated by autograd; "covar" takes
                    the batch moments from Gram(h) (:func:`covar_moments`)
  analytic          plain torch with the hand-derived backward
                    (ops/analytic_sa.py), with an input gradient
  hybrid            plain forward + the two-sweep backward (B8,
                    ops/sa_bwd.py)
  hybrid2           the four-sweep forward (B7, ops/sa_fwd.py) + B8
  pair, pair3       B2 + B3 sweep 1, then B6 (pair) or B3's slim sweeps
                    (pair3) (ops/sa_pair.py)
  pallas            the generic fused kernel B9 (ops/sa_kernel.py via
                    ops/fused_sa.py::sa_train_fused) on rows (B*S*K, C);
                    with ``input_grad`` its final sweep returns the true
                    input gradient, else the input cotangent is zeros

Eval mode is plain math with the running statistics (sa_stage.py:221-268).
With ``channels_first`` the input is (B, C, S, K); every impl but
pair/pair3, and eval, transposes it to channels-last first
(sa_stage.py:98-105).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from facl_tpu_torch.models.layers import lecun_normal_
from facl_tpu_torch.ops._launch import TRUNK
from facl_tpu_torch.ops.analytic_sa import sa_train_analytic
from facl_tpu_torch.ops.fused_sa import SALayerParams, sa_reference_4d, \
    sa_train_fused
from facl_tpu_torch.ops.sa_bwd import sa_train_hybrid
from facl_tpu_torch.ops.sa_fwd import _moments_from_gram, sa_train_pfwd
from facl_tpu_torch.ops.sa_pair import sa_train_pair

#: Train-mode implementations of the stage.
IMPLS = ("reference", "covar", "analytic", "hybrid", "hybrid2", "pair",
         "pair3", "pallas")
#: The impls that run the sweep kernels B2-B8: their input cotangent is
#: zero by contract, and on the card they take only SA widths TRUNK.
SWEEPS = ("hybrid", "hybrid2", "pair", "pair3")


def covar_moments(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor):
    """Batch (mean, var) of p = h @ kernel + bias from Gram(h) and
    colsum(h), without reducing p (facl_tpu/models/sa_stage.py:33-68);
    the variance clamped at 0."""
    flat = h.reshape(-1, h.shape[-1])
    return _moments_from_gram(flat.T @ flat, flat.sum(0), kernel, bias,
                              flat.shape[0])


class SetAbstractionStage(nn.Module):
    """Input (B, S, K, C), or (B, C, S, K) with ``channels_first``;
    output (B, S, widths[-1])."""

    def __init__(self, in_features: int, widths: Sequence[int],
                 bn_momentum: float = 0.9, epsilon: float = 1e-5,
                 channels_first: bool = True, impl: str = "pair3",
                 input_grad: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"unknown SA impl {impl!r}; expected one of "
                             f"{IMPLS}")
        self.widths = tuple(widths)
        self.bn_momentum, self.epsilon = bn_momentum, epsilon
        self.channels_first = channels_first
        self.impl, self.input_grad = impl, input_grad
        cin = in_features
        for i, w in enumerate(self.widths):
            self.register_parameter(f"kernel_{i}", nn.Parameter(
                lecun_normal_(torch.empty(cin, w), cin, generator)))
            self.register_parameter(f"bias_{i}",
                                    nn.Parameter(torch.zeros(w)))
            self.register_parameter(f"scale_{i}",
                                    nn.Parameter(torch.ones(w)))
            self.register_parameter(f"shift_{i}",
                                    nn.Parameter(torch.zeros(w)))
            self.register_buffer(f"mean_{i}", torch.zeros(w))
            self.register_buffer(f"var_{i}", torch.ones(w))
            cin = w

    def layers(self):
        return tuple(SALayerParams(*(getattr(self, f"{n}_{i}") for n in
                                     ("kernel", "bias", "scale", "shift")))
                     for i in range(len(self.widths)))

    def running(self):
        return [(getattr(self, f"mean_{i}"), getattr(self, f"var_{i}"))
                for i in range(len(self.widths))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 4:
            raise ValueError(f"expected 4-D neighbourhoods, got {x.shape}")
        impl, layers, eps = self.impl, self.layers(), self.epsilon
        pair = impl in ("pair", "pair3")
        if self.training and self.input_grad and impl in SWEEPS:
            raise ValueError(
                f"sa impl {impl!r} defines a zero input cotangent; use "
                "'analytic' when input gradients are needed")
        if self.training and impl in SWEEPS and x.device.type == "cuda" \
                and self.widths != TRUNK:
            others = tuple(i for i in IMPLS if i not in SWEEPS)
            raise ValueError(
                f"sa impl {impl!r} runs kernels that take SA widths {TRUNK} "
                f"(TRUNK) on the card; got widths {self.widths}. Use one of "
                f"{others}, which take these widths, or sa_impl='auto'")
        if self.channels_first and not (self.training and pair):
            x = x.permute(0, 2, 3, 1)                       # (B, S, K, C)
        if not self.training:
            pooled, _, _, _ = sa_reference_4d(x, layers, eps, self.running())
            return pooled
        if pair:
            x_cf = x if self.channels_first else x.permute(0, 3, 1, 2)
            pooled, stats = sa_train_pair(x_cf, layers, eps,
                                          slim=impl == "pair3")
        elif impl == "hybrid":
            pooled, stats = sa_train_hybrid(x, layers, eps)
        elif impl == "hybrid2":
            pooled, stats = sa_train_pfwd(x, layers, eps)
        elif impl == "pallas":
            B, S, K, C = x.shape
            pooled, stats = sa_train_fused(x.reshape(B * S * K, C), layers, K,
                                           eps, need_dx=self.input_grad)
            pooled = pooled.view(B, S, -1)
        elif impl == "analytic":
            pooled, stats = sa_train_analytic(x, layers, eps)
        else:
            moments = (lambda h, lp: covar_moments(h, lp.kernel, lp.bias)) \
                if impl == "covar" else None
            pooled, stats, _, _ = sa_reference_4d(x, layers, eps,
                                                  moments=moments)
        m = self.bn_momentum
        with torch.no_grad():
            for (mean_b, var_b), (mean, var) in zip(self.running(), stats):
                mean_b.copy_(m * mean_b + (1 - m) * mean)
                var_b.copy_(m * var_b + (1 - m) * var)
        return pooled
