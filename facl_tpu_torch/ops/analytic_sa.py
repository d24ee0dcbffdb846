"""The SA stage with a hand-derived backward: ``sa_impl="analytic"``
(counterpart of facl_tpu/ops/analytic_sa.py).

The forward is the reference op sequence (ops/fused_sa.py::
sa_reference_4d). The backward walks the layers from the top without
autodiff: per layer, BatchNorm's two per-channel sums collapse into
A = dy^T h_prev and u = sum dy, the mean/variance terms of dW into
colsum(h_prev) and Gram(h_prev) (ops/sa_bwd.py::_layer_terms), and the
input gradient into dh_prev = (gi dy) W^T - h_prev M - rc. The top layer
is recomputed from the stored h2, and each pooled cotangent is split
evenly among its group's exact ties on the f32 relu(z), where z > 0
(ops/sa_bwd.py::_dy_top, the same rule as the two-sweep kernels).

At ``dtype=torch.bfloat16`` the forward is the bf16 reference and the
backward rounds where JAX's backward (facl_tpu/ops/analytic_sa.py:110-219)
rounds as XLA compiles it under jit, as the Trainer runs it (its
outputs show which casts round): the top layer recomputed as z = (bf16(
h_prev bf16(W)) + bf16(b)) mul + shift in f32 (the bf16 sum kept in f32),
its pool ties taken on the f32 relu(z) and dy rounded to bf16; A = dy^T
h_prev, Gram(h_prev) and colsum(h_prev) as f32 sums of the bf16 values;
the small term products in f32; dh_prev = bf16(bf16(dy bf16(gi)) bf16(W)^T)
- bf16(h_prev bf16(M)) - rc in f32 (again the difference of two bf16
values kept in f32), masked and rounded to bf16 as the next dy, and
returned unrounded (f32) as the input gradient.

Under data parallelism (``mesh``) the forward's batch moments are over
every rank's rows (``sa_reference_4d`` with the mesh), and each layer's
backward sums A, u, Gram(h_prev) and colsum(h_prev) over the ranks in one
float64 ``psum_packed`` (as B6s sums its accumulators) before the
closed-form terms, with the global row count: the parameter gradients come
back global, and dh_prev is this rank's rows. JAX's GSPMD partitions its
plain XLA stage to the same global sums.

Plain PyTorch, no kernel: the JAX function has none. The returned stats
carry no gradient (they feed the running-statistics update).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from facl_tpu_torch.ops.fused_sa import BF16, SALayerParams, \
    sa_reference_4d
from facl_tpu_torch.ops.sa_bwd import _dy_top, _fold_affine, \
    _layer_terms, _rb, _same
from facl_tpu_torch.parallel.collectives import psum_packed
from facl_tpu_torch.parallel.mesh import distributed


def _layer_sums(dy, h_prev, mesh):
    """A = dy^T h_prev, u = sum dy, Gram(h_prev), colsum(h_prev): this
    rank's rows' sums, summed over the ranks (one float64 all-reduce)."""
    return psum_packed([dy.T @ h_prev, dy.sum(0), h_prev.T @ h_prev,
                        h_prev.sum(0)], mesh)


def _layer_bwd(dy, h_prev, lp: SALayerParams, mean, var, eps: float,
               dtype: torch.dtype = torch.float32, mesh=None):
    """One Dense + BatchNorm(train) + ReLU backward from dy (rows, C),
    already ReLU-masked, and the layer input h_prev (rows, Cin), both
    holding ``dtype`` values (f32 tensors): -> (dW, db, dgamma, dbeta,
    dh_prev) (facl_tpu/ops/analytic_sa.py:110-172, casts as the module
    docstring says); the parameter gradients over every rank's rows with
    ``mesh``."""
    r = _rb if dtype == BF16 else _same
    n = h_prev.shape[0] * (mesh.dp if distributed(mesh) else 1)
    A, u, gram, ch = _layer_sums(dy, h_prev, mesh)
    t = _layer_terms(A, u, lp, mean, var, gram, ch, n, eps)
    dh = r(r(dy * r(t["gi"])) @ r(lp.kernel).T) \
        - r(h_prev @ r(t["M"])) - t["rc"]
    return t["dW"], t["db"], t["dgamma"], t["dbeta"], dh


class _Analytic(torch.autograd.Function):
    """pooled, *stats = f(x, eps, n_layers, dtype, mesh, *4L layer
    tensors)."""

    @staticmethod
    def forward(ctx, x, eps, n_layers, dtype, mesh, *flat):
        layers = [SALayerParams(*flat[4 * i:4 * i + 4])
                  for i in range(n_layers)]
        pooled, stats, _, hs = sa_reference_4d(x, layers, eps, dtype=dtype,
                                               mesh=mesh)
        flat_stats = [m for s in stats for m in s]
        ctx.eps, ctx.n_layers, ctx.dtype, ctx.mesh = eps, n_layers, dtype, \
            mesh
        ctx.x_dtype = x.dtype
        ctx.save_for_backward(*hs, *flat, *flat_stats)
        ctx.mark_non_differentiable(*flat_stats)
        return (pooled, *flat_stats)

    @staticmethod
    def backward(ctx, dpooled, *_):
        L, eps = ctx.n_layers, ctx.eps
        r = _rb if ctx.dtype == BF16 else _same
        saved = ctx.saved_tensors
        x = saved[0]
        K = x.shape[-2]
        hs = [h.reshape(-1, h.shape[-1]) for h in saved[:L]]
        hs = [h.float() if h.dtype == BF16 else h for h in hs]
        flat, st = saved[L:5 * L], saved[5 * L:]
        layers = [SALayerParams(*flat[4 * i:4 * i + 4]) for i in range(L)]
        stats = [(st[2 * i], st[2 * i + 1]) for i in range(L)]

        lp, (mean, var) = layers[-1], stats[-1]
        mul, shift = _fold_affine(lp, mean, var, eps)
        z = (r(hs[-1] @ r(lp.kernel)) + r(lp.bias)) * mul + shift
        dy = r(_dy_top(z, dpooled.reshape(-1, z.shape[1]).to(z.dtype), K))
        grads = [None] * L
        for li in range(L - 1, -1, -1):
            *grads[li], dh = _layer_bwd(dy, hs[li], layers[li], *stats[li],
                                        eps, ctx.dtype, ctx.mesh)
            dy = r(torch.where(hs[li] > 0, dh, 0.0)) if li > 0 else dh
        return (dy.reshape(x.shape).to(ctx.x_dtype), None, None, None, None,
                *(g for layer in grads for g in layer))


def sa_train_analytic(x: torch.Tensor, layers: Sequence[SALayerParams],
                      eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                      mesh=None) -> Tuple[torch.Tensor, list]:
    """x (..., K, C0), max-pooled over K. Returns (pooled (..., C_L),
    [(mean, var)] per layer): the reference path's values at ``dtype``
    (pooled in bf16 at bf16), with the hand-derived backward (module
    docstring); with ``mesh`` (this rank's block of x) the statistics and
    the parameter gradients are global."""
    L = len(layers)
    out = _Analytic.apply(x, eps, L, dtype, mesh,
                          *(t for lp in layers for t in lp))
    st = out[1:]
    return out[0], [(st[2 * i], st[2 * i + 1]) for i in range(L)]
