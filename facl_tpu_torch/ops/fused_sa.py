"""Set-abstraction stage semantics: [Dense -> BatchNorm(train) -> ReLU] x L
then a max-pool over the neighbour axis (counterpart of
facl_tpu/ops/fused_sa.py:27-92). The plain references here define what
the SA kernels (ops/sa_pair.py, sa_fwd.py, sa_bwd.py) compute; tests hold
both against each other and against the JAX package.

Statistics are float32 and biased (flax convention); the returned
(mean, var) per layer feed the caller's running-statistics update.

At ``compute_dtype=torch.bfloat16`` the references follow the JAX casts
(facl_tpu/ops/fused_sa.py:48-95, facl_tpu/models/sa_stage.py:227-268): the
input is cast, each Dense multiplies and adds its bias in bf16 (from the
f32 parameters), the moments come from p's f32 upcast, and the affine runs
in f32 and is cast back to bf16 before the ReLU. Any other dtype runs the
ops in the input's own dtype, with no cast.

:func:`sa_train_fused` is ``sa_impl="pallas"`` (facl_tpu/ops/fused_sa.py:
95-160): the forward and backward sweeps of kernel B9 (ops/sa_kernel.py)
behind one ``torch.autograd.Function``, differentiable in x and every
layer parameter, at f32 or (``compute_dtype=torch.bfloat16``) with B9's
bf16 sweeps.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from facl_tpu_torch.parallel.collectives import global_moments


class SALayerParams(NamedTuple):
    kernel: torch.Tensor   # (Cin, Cout)
    bias: torch.Tensor     # (Cout,)
    scale: torch.Tensor    # (Cout,) BN gamma
    shift: torch.Tensor    # (Cout,) BN beta


BF16 = torch.bfloat16


def _dense(h, lp: SALayerParams, dtype):
    """h W + b; at bf16 both in bf16 from the f32 parameters."""
    if dtype != BF16:
        return h @ lp.kernel + lp.bias
    return h.to(dtype) @ lp.kernel.to(dtype) + lp.bias.to(dtype)


def _bn_train(p: torch.Tensor, eps: float):
    mean = p.mean(0)
    var = ((p * p).mean(0) - mean * mean).clamp_min(0.0)
    return (p - mean) * torch.rsqrt(var + eps), mean, var


def sa_train_reference(x: torch.Tensor, layers: Sequence[SALayerParams],
                       pool_size: int, eps: float = 1e-5,
                       compute_dtype: torch.dtype = torch.float32
                       ) -> Tuple[torch.Tensor,
                                  List[Tuple[torch.Tensor, torch.Tensor]]]:
    """x: (R, C0) rows, R a multiple of pool_size. Returns (pooled
    (R // pool_size, C_last), [(mean, var)] per layer). Differentiable by
    autograd — the gradient baseline of the pair3 backward."""
    bf = compute_dtype == BF16
    h = x.to(BF16) if bf else x
    stats = []
    for lp in layers:
        p = _dense(h, lp, compute_dtype)
        xhat, mean, var = _bn_train(p.float() if bf else p, eps)
        h = xhat * lp.scale + lp.shift
        h = torch.relu(h.to(BF16) if bf else h)
        stats.append((mean, var))
    R, C = h.shape
    return h.reshape(R // pool_size, pool_size, C).amax(1), stats


def sa_eval_reference(x: torch.Tensor, layers: Sequence[SALayerParams],
                      running: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                      pool_size: int, eps: float = 1e-5,
                      compute_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """Eval-mode forward using running statistics."""
    bf = compute_dtype == BF16
    h = x.to(BF16) if bf else x
    for lp, (mean, var) in zip(layers, running):
        p = _dense(h, lp, compute_dtype)
        h = ((p.float() if bf else p) - mean) * torch.rsqrt(var + eps) \
            * lp.scale + lp.shift
        h = torch.relu(h.to(BF16) if bf else h)
    R, C = h.shape
    return h.reshape(R // pool_size, pool_size, C).amax(1)


def sa_reference_4d(x: torch.Tensor, layers: Sequence[SALayerParams],
                    eps: float = 1e-5, running=None, moments=None,
                    dtype: torch.dtype = torch.float32, mesh=None):
    """The op sequence of facl_tpu/models/sa_stage.py::_reference_4d on
    (..., K, C0) neighbourhoods: per layer p = h W + b, its batch moments
    (reductions over every axis but the last, the variance clamped at 0;
    or ``moments(h, lp)``; or ``running[i]`` in eval mode), the folded
    affine y = p * mul + shift, ReLU; then the max over K. Returns (pooled
    (..., C_L), [(mean, var)] per layer, the pre-activations [p1, ..,
    pL], the layer inputs [x, h1, .., h_{L-1}]). Plain torch,
    differentiable by autograd; also the forward of the hybrid and
    analytic paths (facl_tpu/ops/pallas/sa_bwd.py:351-373,
    facl_tpu/ops/analytic_sa.py:47-70). At ``dtype=torch.bfloat16`` the
    stage's bf16 form (module docstring): the reference impl and the eval
    path at that compute dtype. With ``mesh`` (data parallelism) the
    batch moments are over every rank's rows
    (parallel/collectives.py::global_moments), differentiable through the
    sum over the ranks."""
    bf = dtype == BF16
    h = x.to(BF16) if bf else x
    stats, ps, hs = [], [], [h]
    for i, lp in enumerate(layers):
        p = _dense(h, lp, dtype)
        if running is not None:
            mean, var = running[i]
        elif moments is not None:
            mean, var = moments(h, lp)
        else:
            flat = p.reshape(-1, p.shape[-1])
            mean, var = global_moments(flat.float() if bf else flat, mesh)
        stats.append((mean, var))
        mul = torch.rsqrt(var + eps) * lp.scale
        shift = lp.shift - mean * mul
        h = p * mul + shift       # rebound: no second (R, C) tensor held
        h = torch.relu(h.to(BF16) if bf else h)
        ps.append(p)
        hs.append(h)
    return h.amax(-2), stats, ps, hs[:-1]


class _SAFused(torch.autograd.Function):
    """pooled, *stats = f(x, pool, eps, need_dx, dtype, *layer tensors)
    for rows x (R, C0); forward and backward are B9's sweeps at ``dtype``.
    The statistics carry no gradient (they feed the running-statistics
    update); without ``need_dx`` the input cotangent is zeros
    (fused_sa.py:133-134)."""

    @staticmethod
    def forward(ctx, x, pool, eps, need_dx, dtype, *flat):
        from facl_tpu_torch.ops.sa_kernel import sa_train_forward_unified
        L = len(flat) // 4
        layers = [SALayerParams(*flat[4 * i:4 * i + 4]) for i in range(L)]
        pooled, stats, packed = sa_train_forward_unified(x, layers, pool,
                                                         eps, dtype)
        flat_stats = [m for st in stats for m in st]
        ctx.pool, ctx.need_dx, ctx.dtype = pool, need_dx, dtype
        ctx.save_for_backward(x, packed, *flat)
        ctx.mark_non_differentiable(*flat_stats)
        return (pooled, *flat_stats)

    @staticmethod
    def backward(ctx, dpooled, *_):
        from facl_tpu_torch.ops.sa_kernel import sa_train_backward_unified
        x, packed, *flat = ctx.saved_tensors
        L = len(flat) // 4
        layers = [SALayerParams(*flat[4 * i:4 * i + 4]) for i in range(L)]
        dx, grads = sa_train_backward_unified(
            x, layers, packed, dpooled.contiguous(), ctx.pool, ctx.need_dx,
            ctx.dtype)
        if dx is None:
            dx = torch.zeros_like(x)
        return (dx, None, None, None, None,
                *(g for layer in grads for g in layer))


def sa_train_fused(x: torch.Tensor, layers: Sequence[SALayerParams],
                   pool_size: int, eps: float = 1e-5, need_dx: bool = True,
                   compute_dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor,
                              List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Kernel B9's stage: x (R, C0) rows, R a multiple of pool_size.
    Returns (pooled (R // pool_size, C_last), [(mean, var)] per layer).
    At ``compute_dtype=torch.bfloat16`` the sweeps read x as float32 (a
    bf16 x is upcast, exactly) and compute in bf16, and the pooled rows
    are float32 holding bf16 values, as JAX's (the caller casts them; the
    cotangent that comes back is then the bf16 one, upcast)."""
    x = x.float() if x.dtype == BF16 else x
    out = _SAFused.apply(x.contiguous(), pool_size, eps, need_dx,
                         compute_dtype, *(t for lp in layers for t in lp))
    st = out[1:]
    return out[0], [(st[2 * i], st[2 * i + 1]) for i in range(len(layers))]


def sa_train(x: torch.Tensor, layers: Sequence[SALayerParams],
             pool_size: int, eps: float = 1e-5, impl: str = "auto",
             compute_dtype: torch.dtype = torch.float32):
    """Dispatching train-mode SA (facl_tpu/ops/fused_sa.py:163-176): impl
    "pallas" or "auto" (the port's rule: B9 on every device, its twins on
    the CPU) -> :func:`sa_train_fused`; "reference" -> the plain math;
    both at ``compute_dtype``."""
    if impl in ("auto", "pallas"):
        return sa_train_fused(x, layers, pool_size, eps,
                              compute_dtype=compute_dtype)
    if impl == "reference":
        return sa_train_reference(x, layers, pool_size, eps, compute_dtype)
    raise ValueError(f"unknown SA impl {impl!r}; expected auto, reference "
                     "or pallas")
