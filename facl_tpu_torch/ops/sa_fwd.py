"""The four-sweep SA forward: kernel B7 and ``sa_impl="hybrid2"``
(counterpart of facl_tpu/ops/pallas/sa_fwd.py), plus the host-side moment
finalizes every SA forward shares (sa_fwd.py:138, :229-239).

  B7a sa_fwd_layer   p = h W + b written, with the sums of p and p^2; run
                     twice: x -> p1 (input cast only) and p1 -> p2 (h1 =
                     relu(p1 * mul1 + shift1) applied to the input tile)
  B7b sa_fwd_gram    Gram(h2), colsum(h2) -> the layer-3 moments by the
                     covariance identity (no (R, 256) tensor exists)
  B7c sa_fwd_pool    recompute p3, the layer-3 affine, ReLU, then the max
                     over each ``pool``-row group (the JAX order)

p1 and p2 are the residuals the two-sweep backward (ops/sa_bwd.py, B8)
reads. Each sweep has a CUDA kernel (B7a ``csrc/sa_layer.cu``, B7b and
B7c ``csrc/sa_2sweep.cu``) and a plain PyTorch twin; a CPU tensor takes
the twin, a CUDA tensor launches the kernel or raises, and each wrapper
counts its launches. At compute_dtype bfloat16 (``dtype=torch.bfloat16``)
the three sweeps have bf16 kernels (``sa_fwd_layer_bf16``,
``sa_fwd_gram_bf16``, ``sa_fwd_pool_bf16``) that store p1, p2 and the
pooled rows in bf16; the moment finalizes stay f32, as XLA keeps them
outside Pallas.

B7a runs one 512-thread block an SM whose warps walk their own row
steps, the input staged by cp.async (so x and p1 must be 16-byte aligned;
the wrapper raises otherwise) and the output leaving in 16-byte stores:
x -> p1 a stream, p1 -> p2 on the bf16 tensor cores at bf16 and on CUDA
cores at f32, where p1 and p2 are the k-order FMA chain's bit for bit.
B7b runs its product on CUDA cores. B7c runs h2 W3 on the tensor cores
(mma.sync at bf16, wgmma in 3xTF32 at f32), one 512-thread block an SM,
its p2 tiles staged by TMA bulk copies (so p2 must be 16-byte aligned;
the wrapper raises otherwise), and reduces each group's max from the
accumulators before the layer-3 affine, roundings and ReLU, which are
monotone in p3: only the order of the f32 sums differs from the twin's.

Input cotangent contract: ZERO, as for ``sa_train_hybrid``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from facl_tpu_torch.ops._launch import I, L, P, TILE, TRUNK, check_c0, \
    check_pool, entry, grid, launch, need, need_aligned, on_cpu, ptr, \
    reduce, stream_of
from facl_tpu_torch.ops.fused_sa import SALayerParams
from facl_tpu_torch.ops.sa_bwd import BF16, _fold_affine, _h_bf16, \
    _h_from_p, _rb, _z_bf16, two_sweep_train


def _finalize(s, ss, n: int):
    """(mean, var) from per-channel sums of p and p^2 over n rows. The
    E[p^2] - E[p]^2 identity can round negative on (near-)constant
    channels, so the variance is clamped at 0."""
    mean = s / n
    var = (ss / n - mean * mean).clamp_min(0.0)
    return mean, var


def _moments_from_gram(G, colsum, w, b, n: int):
    """Batch mean/var of p = h W + b from Gram(h), colsum(h) (the
    covariance identity, facl_tpu/ops/pallas/sa_fwd.py:229-239,
    sa_pair.py:601-629,683-692), clamped at 0."""
    mean = colsum @ w / n + b
    e2 = ((G @ w) * w).sum(0) / n + b * (2.0 * mean - b)
    return mean, (e2 - mean * mean).clamp_min(0.0)


# -- plain twins --------------------------------------------------------

def sa_fwd_layer_plain(inp, w, b, mul=None, shift=None):
    """-> (p = h W + b, sum p, sum p^2); h = inp, or relu(inp * mul +
    shift) when ``mul`` is given."""
    h = inp if mul is None else _h_from_p(inp, mul, shift)
    p = h @ w + b
    return p, p.sum(0), (p * p).sum(0)


def sa_fwd_gram_plain(p2, mul2, shift2):
    """-> (Gram(h2), colsum(h2))."""
    h2 = _h_from_p(p2, mul2, shift2)
    return h2.T @ h2, h2.sum(0)


def sa_fwd_pool_plain(p2, mul2, shift2, w3, b3, mul3, shift3, pool: int):
    """-> max over each ``pool``-row group of relu((h2 W3 + b3) * mul3 +
    shift3), (R // pool, C3)."""
    z = (_h_from_p(p2, mul2, shift2) @ w3 + b3) * mul3 + shift3
    return torch.relu(z).reshape(-1, pool, z.shape[1]).amax(1)


# -- bf16 twins ----------------------------------------------------------
# B7 at compute_dtype bfloat16 (facl_tpu/ops/pallas/sa_fwd.py:65-140 at
# dtype=bfloat16), by the rule of ops/sa_bwd.py's bf16 twins: p = bf16(h
# W) + bf16(b) is stored rounded to bf16 and summed for its moments in f32
# before that rounding; the pool sweep rounds the layer-3 affine to bf16
# before its ReLU and stores the pooled rows in bf16.

def sa_fwd_layer_bf16_plain(inp, w, b, mul=None, shift=None):
    """-> (p (R, 64) bf16, sum p, sum p^2 in f32); h = the bf16 input, or
    relu(bf16(inp mul + shift)) when ``mul`` is given."""
    h = inp.float() if mul is None else _h_bf16(inp, mul, shift)
    p = _rb(h @ _rb(w)) + _rb(b)
    return p.to(BF16), p.sum(0), (p * p).sum(0)


def sa_fwd_gram_bf16_plain(p2, mul2, shift2):
    """-> (Gram(h2), colsum(h2)) in f32 of the bf16 h2."""
    h2 = _h_bf16(p2, mul2, shift2)
    return h2.T @ h2, h2.sum(0)


def sa_fwd_pool_bf16_plain(p2, mul2, shift2, w3, b3, mul3, shift3,
                           pool: int):
    """-> max over each ``pool``-row group of relu(bf16(z)), (R // pool,
    C3) bf16 (z: ops/sa_bwd.py::_z_bf16)."""
    z = _z_bf16(_h_bf16(p2, mul2, shift2), w3, b3, mul3, shift3)
    return torch.relu(_rb(z)).reshape(-1, pool, z.shape[1]).amax(1).to(BF16)


# -- kernel wrappers ----------------------------------------------------
# Each sweep has an f32 and a bf16 kernel (csrc/sa_layer.cu, sa_2sweep.cu;
# entry points facl_sa_*, facl_sa_*_bf16), each with its own wrapper, twin
# and launch counter. ``dt`` is the storage dtype of the rows (x, p1, p2,
# pooled); a row tensor stored otherwise raises.

def _layer(inp, w, b, mul, shift, dt):
    R, cin = inp.shape
    C = TRUNK[0]
    affine = mul is not None
    need(inp, (R, C if affine else cin), "p1" if affine else "x", dt)
    if affine:
        if R % TILE:
            raise ValueError(f"the SA kernels take a row count divisible "
                             f"by {TILE}; got rows={R}")
    else:
        check_c0(cin, R)
    need(w, (cin, C), "w")
    need_aligned(inp, "p1" if affine else "x")
    zero = torch.zeros(C, dtype=torch.float32, device=inp.device)
    vec = torch.cat([b, mul if affine else zero,
                     shift if affine else zero]).contiguous()
    need(vec, (3 * C,), "b|mul|shift")
    nblk = grid(inp, R, per_sm=1)     # one 512-thread block an SM
    p = torch.empty((R, C), dtype=dt, device=inp.device)
    part = torch.empty((nblk, 2, C), dtype=torch.float64, device=inp.device)
    launch("sa_layer", entry("fwd_layer", dt), [P, L, I, I, P, P, P, P, I, P],
           ptr(inp), R, cin, int(affine), ptr(w), ptr(vec), ptr(p),
           ptr(part), nblk, stream_of(inp), what=entry("fwd_layer", dt))
    s = reduce(part)
    return p, s[0], s[1]


def _gram(p2, mul2, shift2, dt):
    R = p2.shape[0]
    C2 = TRUNK[1]
    need(p2, (R, C2), "p2", dt)
    if R % TILE:
        raise ValueError(f"the SA kernels take a row count divisible by "
                         f"{TILE}; got rows={R}")
    vec2 = torch.cat([mul2, shift2]).contiguous()
    need(vec2, (2 * C2,), "mul2|shift2")
    nblk = grid(p2, R)
    partG = torch.empty((nblk, C2, C2), dtype=torch.float64,
                        device=p2.device)
    partc = torch.empty((nblk, C2), dtype=torch.float64, device=p2.device)
    launch("sa_2sweep", entry("fwd_gram", dt), [P, L, P, P, P, I, P],
           ptr(p2), R, ptr(vec2), ptr(partG), ptr(partc), nblk,
           stream_of(p2), what=entry("fwd_gram", dt))
    return reduce(partG), reduce(partc)


def _pool(p2, mul2, shift2, w3, b3, mul3, shift3, pool, dt):
    R = p2.shape[0]
    C2, C3 = TRUNK[1], TRUNK[2]
    check_pool(R, pool)
    need(p2, (R, C2), "p2", dt)
    need(w3, (C2, C3), "w3")
    vec = torch.cat([mul2, shift2, b3, mul3, shift3]).contiguous()
    need(vec, (2 * C2 + 3 * C3,), "mul2|shift2|b3|mul3|shift3")
    need_aligned(p2, "p2")
    nblk = grid(p2, R, per_sm=1)      # one 512-thread block an SM: its
                                      # registers leave room for no second
    pooled = torch.empty((R // pool, C3), dtype=dt, device=p2.device)
    launch("sa_2sweep", entry("fwd_pool", dt), [P, L, I, P, P, P, I, P],
           ptr(p2), R, pool, ptr(vec), ptr(w3), ptr(pooled), nblk,
           stream_of(p2), what=entry("fwd_pool", dt))
    return pooled


def sa_fwd_layer(inp, w, b, mul=None, shift=None):
    """B7a. inp: x rows (R, C0) without ``mul``, or p1 (R, 64) with the
    layer-1 folded affine. -> (p (R, 64), sum p, sum p^2). On the card inp
    must be 16-byte aligned."""
    if on_cpu(inp):
        return sa_fwd_layer_plain(inp, w, b, mul, shift)
    out = _layer(inp, w, b, mul, shift, torch.float32)
    sa_fwd_layer.launches += 1
    return out


def sa_fwd_gram(p2, mul2, shift2):
    """B7b. -> (Gram(h2) (64, 64), colsum(h2) (64,))."""
    if on_cpu(p2):
        return sa_fwd_gram_plain(p2, mul2, shift2)
    out = _gram(p2, mul2, shift2, torch.float32)
    sa_fwd_gram.launches += 1
    return out


def sa_fwd_pool(p2, mul2, shift2, w3, b3, mul3, shift3, pool: int):
    """B7c. -> pooled (R // pool, 256). On the card p2 must be 16-byte
    aligned."""
    if on_cpu(p2):
        return sa_fwd_pool_plain(p2, mul2, shift2, w3, b3, mul3, shift3,
                                 pool)
    out = _pool(p2, mul2, shift2, w3, b3, mul3, shift3, pool, torch.float32)
    sa_fwd_pool.launches += 1
    return out


def sa_fwd_layer_bf16(inp, w, b, mul=None, shift=None):
    """B7a at bf16: x rows or p1 bf16 -> (p (R, 64) bf16, sum p, sum p^2
    in f32). On the card inp must be 16-byte aligned."""
    if on_cpu(inp):
        return sa_fwd_layer_bf16_plain(inp, w, b, mul, shift)
    out = _layer(inp, w, b, mul, shift, BF16)
    sa_fwd_layer_bf16.launches += 1
    return out


def sa_fwd_gram_bf16(p2, mul2, shift2):
    """B7b at bf16: p2 bf16 -> (Gram(h2), colsum(h2)) in f32."""
    if on_cpu(p2):
        return sa_fwd_gram_bf16_plain(p2, mul2, shift2)
    out = _gram(p2, mul2, shift2, BF16)
    sa_fwd_gram_bf16.launches += 1
    return out


def sa_fwd_pool_bf16(p2, mul2, shift2, w3, b3, mul3, shift3, pool: int):
    """B7c at bf16: p2 bf16 -> pooled (R // pool, 256) bf16. On the card
    p2 must be 16-byte aligned."""
    if on_cpu(p2):
        return sa_fwd_pool_bf16_plain(p2, mul2, shift2, w3, b3, mul3, shift3,
                                      pool)
    out = _pool(p2, mul2, shift2, w3, b3, mul3, shift3, pool, BF16)
    sa_fwd_pool_bf16.launches += 1
    return out


KERNELS = (sa_fwd_layer, sa_fwd_gram, sa_fwd_pool, sa_fwd_layer_bf16,
           sa_fwd_gram_bf16, sa_fwd_pool_bf16)
for _k in KERNELS:
    _k.launches = 0


def _sweeps(dtype):
    """B7's three sweeps at ``dtype``: the bf16 ones, or the f32 ones for
    any other dtype (the module's names, read at call time)."""
    if dtype == BF16:
        return sa_fwd_layer_bf16, sa_fwd_gram_bf16, sa_fwd_pool_bf16
    return sa_fwd_layer, sa_fwd_gram, sa_fwd_pool


# -- the stage ----------------------------------------------------------

def sa_forward_4sweep(x, layers: Sequence[SALayerParams], pool: int,
                      eps: float, dtype=torch.float32):
    """The four-sweep forward (sa_fwd.py:148-258). x (R, C0) rows stored
    in ``dtype`` (bf16 runs the bf16 sweeps; any other dtype the f32
    form), ``pool`` consecutive rows per output row. Returns (pooled (R //
    pool, C3) and p1, p2 in x's dtype, [(mean, var)] x 3 in f32)."""
    sa_fwd_layer, sa_fwd_gram, sa_fwd_pool = _sweeps(dtype)
    lp1, lp2, lp3 = layers
    n = x.shape[0]
    p1, s1, ss1 = sa_fwd_layer(x, lp1.kernel, lp1.bias)
    mean1, var1 = _finalize(s1, ss1, n)
    mul1, shift1 = _fold_affine(lp1, mean1, var1, eps)
    p2, s2, ss2 = sa_fwd_layer(p1, lp2.kernel, lp2.bias, mul1, shift1)
    mean2, var2 = _finalize(s2, ss2, n)
    mul2, shift2 = _fold_affine(lp2, mean2, var2, eps)
    G2, ch2 = sa_fwd_gram(p2, mul2, shift2)
    mean3, var3 = _moments_from_gram(G2, ch2, lp3.kernel, lp3.bias, n)
    mul3, shift3 = _fold_affine(lp3, mean3, var3, eps)
    pooled = sa_fwd_pool(p2, mul2, shift2, lp3.kernel, lp3.bias, mul3,
                         shift3, pool)
    return pooled, [(mean1, var1), (mean2, var2), (mean3, var3)], p1, p2


def sa_train_pfwd(x: torch.Tensor, layers: Sequence[SALayerParams],
                  eps: float = 1e-5, dtype=torch.float32
                  ) -> Tuple[torch.Tensor, list]:
    """``sa_impl="hybrid2"``: the four-sweep forward (B7) + the two-sweep
    backward (B8) on its p1/p2. x (..., K, C0), max-pooled over K;
    ``dtype=torch.bfloat16`` runs the bf16 sweeps on x cast to bf16, and
    the pooled output is then bf16. Returns (pooled (..., C3), [(mean,
    var)] x 3). Differentiable in every layer parameter; the input
    cotangent is ZERO."""
    return two_sweep_train(sa_forward_4sweep, x, layers, eps, "hybrid2",
                           dtype)
