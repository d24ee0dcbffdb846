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

``dtype`` is the compute dtype (facl_tpu/models/sa_stage.py:227-268): at
``torch.bfloat16`` every impl trains in bf16 — pair3 and pair (the bf16
sweeps of B2/B3 and B6), hybrid2 (B7 and B8 at bf16), hybrid (the bf16
reference forward and B8 at bf16), pallas (B9 at bf16), reference, covar
and analytic (plain bf16) —, eval runs the bf16 reference, and the
pooled output is bf16 (sa_stage.py:225); parameters and statistics stay
f32.

``mesh`` (data parallelism, parallel/mesh.py): the input is this rank's
block of the batch and the train-mode statistics are over every rank's
rows, as JAX's stage computes on a dp mesh (sa_stage.py:85-92,188-192).
pair/pair3 sum their sweep accumulators over the ranks (B6s), and
analytic its backward sums (ops/analytic_sa.py), so their parameter
gradients come back global (``global_grads``); reference takes its
moments by a differentiable sum over the ranks, covar its Gram and column
sums (``covar_moments``), as GSPMD partitions JAX's plain XLA stage. The
stage is replicated over the mesh's mp ranks. hybrid, hybrid2 and pallas
raise NotImplementedError in train mode under a process group: JAX does
not partition them either (their Pallas kernels are single-device
programs under GSPMD, facl_tpu/models/sa_stage.py:10-13). Eval mode needs
no collective (running statistics) and runs with every impl.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from facl_tpu_torch.models.layers import lecun_normal_
from facl_tpu_torch.ops._launch import TRUNK
from facl_tpu_torch.ops.analytic_sa import sa_train_analytic
from facl_tpu_torch.ops.fused_sa import BF16, SALayerParams, \
    sa_reference_4d, sa_train_fused
from facl_tpu_torch.ops.sa_bwd import sa_train_hybrid
from facl_tpu_torch.ops.sa_fwd import _moments_from_gram, sa_train_pfwd
from facl_tpu_torch.ops.sa_pair import sa_train_pair
from facl_tpu_torch.parallel.collectives import global_gram
from facl_tpu_torch.parallel.mesh import distributed, joined

#: Train-mode implementations of the stage.
IMPLS = ("reference", "covar", "analytic", "hybrid", "hybrid2", "pair",
         "pair3", "pallas")
#: The impls that run the sweep kernels B2-B8: their input cotangent is
#: zero by contract, and on the card they take only SA widths TRUNK.
SWEEPS = ("hybrid", "hybrid2", "pair", "pair3")
#: The train-mode impls that run under a process group: those JAX runs
#: on a mesh (pair/pair3 by shard_map, the plain XLA ones by GSPMD).
DP_IMPLS = ("pair", "pair3", "reference", "covar", "analytic")
#: The train-mode impls whose parameter gradients come back global under
#: data parallelism (their backward sums its accumulators over the ranks).
GLOBAL_GRAD_IMPLS = ("pair", "pair3", "analytic")


def check_impl_on_mesh(impl: str, mesh) -> None:
    """Raise NotImplementedError for a train-mode ``impl`` that has no
    sharded form, where ``mesh`` joins this process to others."""
    if joined(mesh) and impl not in DP_IMPLS:
        raise NotImplementedError(
            f"sa impl {impl!r} on a mesh of dp={mesh.dp} x mp={mesh.mp} "
            "ranks: JAX does not partition it either (its Pallas kernels "
            "are single-device programs under GSPMD, facl_tpu/models/"
            f"sa_stage.py:10-13); use one of {DP_IMPLS}")


def covar_moments(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                  mesh=None):
    """Batch (mean, var) of p = h @ kernel + bias from Gram(h) and
    colsum(h), without reducing p (facl_tpu/models/sa_stage.py:33-68);
    the variance clamped at 0. A bf16 ``h`` gives an f32 Gram of its
    values (f32 sums of exact products) and f32 column sums, finalised
    with the f32 ``kernel`` and ``bias``. With ``mesh`` the Gram and
    column sums are over every rank's rows, differentiable through the
    sum (``global_gram``), and the row count is global."""
    flat = h.reshape(-1, h.shape[-1])
    flat = flat.float() if flat.dtype == BF16 else flat
    gram, ch = global_gram(flat, mesh)
    n = flat.shape[0] * (mesh.dp if distributed(mesh) else 1)
    return _moments_from_gram(gram, ch, kernel, bias, n)


class SetAbstractionStage(nn.Module):
    """Input (B, S, K, C), or (B, C, S, K) with ``channels_first``;
    output (B, S, widths[-1])."""

    def __init__(self, in_features: int, widths: Sequence[int],
                 bn_momentum: float = 0.9, epsilon: float = 1e-5,
                 channels_first: bool = True, impl: str = "pair3",
                 input_grad: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        if impl not in IMPLS:
            raise ValueError(f"unknown SA impl {impl!r}; expected one of "
                             f"{IMPLS}")
        self.dtype, self.mesh = dtype, mesh
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

    @property
    def global_grads(self) -> bool:
        """True where the train-mode backward already sums its parameter
        gradients over the ranks (pair/pair3 under a mesh, B6s; analytic)."""
        return distributed(self.mesh) and self.impl in GLOBAL_GRAD_IMPLS

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
        if self.training:
            check_impl_on_mesh(impl, self.mesh)
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
            pooled, _, _, _ = sa_reference_4d(x, layers, eps, self.running(),
                                              dtype=self.dtype)
            return pooled
        if pair:
            x_cf = x if self.channels_first else x.permute(0, 3, 1, 2)
            pooled, stats = sa_train_pair(x_cf, layers, eps,
                                          slim=impl == "pair3",
                                          dtype=self.dtype, mesh=self.mesh)
        elif impl == "hybrid":
            pooled, stats = sa_train_hybrid(x, layers, eps, self.dtype)
        elif impl == "hybrid2":
            pooled, stats = sa_train_pfwd(x, layers, eps, self.dtype)
        elif impl == "pallas":
            B, S, K, C = x.shape
            pooled, stats = sa_train_fused(x.reshape(B * S * K, C), layers, K,
                                           eps, self.input_grad, self.dtype)
            pooled = pooled.view(B, S, -1)
            if self.dtype == BF16:      # f32 rows holding bf16 values
                pooled = pooled.to(BF16)
        elif impl == "analytic":
            pooled, stats = sa_train_analytic(x, layers, eps, self.dtype,
                                              self.mesh)
        else:
            mesh = self.mesh
            moments = (lambda h, lp: covar_moments(h, lp.kernel, lp.bias,
                                                   mesh)) \
                if impl == "covar" else None
            pooled, stats, _, _ = sa_reference_4d(x, layers, eps,
                                                  moments=moments,
                                                  dtype=self.dtype,
                                                  mesh=self.mesh)
        m = self.bn_momentum
        with torch.no_grad():
            for (mean_b, var_b), (mean, var) in zip(self.running(), stats):
                mean_b.copy_(m * mean_b + (1 - m) * mean)
                var_b.copy_(m * var_b + (1 - m) * var)
        return pooled
