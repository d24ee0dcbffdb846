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

Plain PyTorch, no kernel: the JAX function has none. It is the port's
only SA path that returns the input gradient (nonzero). The returned
stats carry no gradient (they feed the running-statistics update).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from facl_tpu_torch.ops.fused_sa import SALayerParams, reject_bf16, \
    sa_reference_4d
from facl_tpu_torch.ops.sa_bwd import _dy_top, _fold_affine, _layer_terms


class _Analytic(torch.autograd.Function):
    """pooled, *stats = f(x, eps, n_layers, *4L layer tensors)."""

    @staticmethod
    def forward(ctx, x, eps, n_layers, *flat):
        layers = [SALayerParams(*flat[4 * i:4 * i + 4])
                  for i in range(n_layers)]
        pooled, stats, _, hs = sa_reference_4d(x, layers, eps)
        flat_stats = [m for s in stats for m in s]
        ctx.eps, ctx.n_layers = eps, n_layers
        ctx.save_for_backward(*hs, *flat, *flat_stats)
        ctx.mark_non_differentiable(*flat_stats)
        return (pooled, *flat_stats)

    @staticmethod
    def backward(ctx, dpooled, *_):
        L, eps = ctx.n_layers, ctx.eps
        saved = ctx.saved_tensors
        x = saved[0]
        K, C0 = x.shape[-2:]
        hs = [h.reshape(-1, h.shape[-1]) for h in saved[:L]]
        flat, st = saved[L:5 * L], saved[5 * L:]
        layers = [SALayerParams(*flat[4 * i:4 * i + 4]) for i in range(L)]
        stats = [(st[2 * i], st[2 * i + 1]) for i in range(L)]
        n = hs[0].shape[0]

        lp, (mean, var) = layers[-1], stats[-1]
        mul, shift = _fold_affine(lp, mean, var, eps)
        z = (hs[-1] @ lp.kernel + lp.bias) * mul + shift
        dy = _dy_top(z, dpooled.reshape(-1, z.shape[1]), K)
        grads = [None] * L
        for li in range(L - 1, -1, -1):
            lp, (mean, var), h_prev = layers[li], stats[li], hs[li]
            t = _layer_terms(dy.T @ h_prev, dy.sum(0), lp, mean, var,
                             h_prev.T @ h_prev, h_prev.sum(0), n, eps)
            grads[li] = (t["dW"], t["db"], t["dgamma"], t["dbeta"])
            dh = (dy * t["gi"]) @ lp.kernel.T - h_prev @ t["M"] - t["rc"]
            dy = torch.where(h_prev > 0, dh, 0.0) if li > 0 else dh
        return (dy.reshape(x.shape), None, None,
                *(g for layer in grads for g in layer))


def sa_train_analytic(x: torch.Tensor, layers: Sequence[SALayerParams],
                      eps: float = 1e-5) -> Tuple[torch.Tensor, list]:
    """x (..., K, C0), max-pooled over K. Returns (pooled (..., C_L),
    [(mean, var)] per layer): the reference path's values, with the
    hand-derived backward (module docstring)."""
    reject_bf16(x.dtype, "analytic")
    L = len(layers)
    out = _Analytic.apply(x, eps, L, *(t for lp in layers for t in lp))
    st = out[1:]
    return out[0], [(st[2 * i], st[2 * i + 1]) for i in range(L)]
