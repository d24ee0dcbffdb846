"""The pair and pair3 set-abstraction stages: kernels B2 (forward), B3
(slim backward) and B6 (the non-slim backward's sweep 2), and the autograd
function that joins them.

Counterpart of facl_tpu/ops/pallas/sa_pair.py::sa_train_pair_cf
(forward ``sa_forward_pair`` :557, backward ``sa_backward_pair`` :711).
Train-mode [Dense -> BN -> ReLU] x 3 + a max-pool over K, computed in row
sweeps:

  B2  sa_fwd_layer12      x -> p1 -> h1 -> p2, sums of p2 and p2^2
      sa_fwd_gram_pool    Gram(h2), colsum(h2), per-group max/min of raw
                          p3 with first indices
  B3  sa_bwd_sweep1       dy3 from the argmax residual; A3, u3; q3 rows
  pair3 (slim=True):
  B3  sa_bwd_sweep2       dy2; A2, G1, u2, ch1; mq = m1 * q2 rows
      sa_bwd_sweep3       dy1 = m1 (mq - h1 M2 - rc2); dy1^T [x | 1]
  pair (slim=False):
  B6  sa_bwd_sweep2_full  dy2; A2, G1, u2, ch1 and layer 1 in third-order
                          moment form (TM1, U1, P1, T1x, cnt1, acc1, Gx, cx;
                          ops/sa_bwd.py::_layer1_terms closes it)

Each sweep has a CUDA kernel (``csrc/sa_pair.cu``; B6 shares B8b's
template in ``csrc/sa_2sweep.cu``, with h1 recomputed from x by the
forward's own h1_tile) and a plain PyTorch twin that returns the same
tensors. A wrapper runs the twin for a CPU tensor and launches the kernel
for a CUDA tensor (or raises); it counts its launches in
``<wrapper>.launches``. The moments of layer 1 (from Gram(x)), the layer-3
finalize, the pool finalize and the closed-form layer algebra between
sweeps are plain PyTorch in f32, as XLA did them outside Pallas. The
TPU's paired-row layout is not ported; rows are (R, C) and the input is
read channel-major, (B, C0, S*K). Both backwards route each pooled
cotangent to the first index of the raw-p3 max (or min) the forward
found.

Input cotangent contract: ZERO (facl_tpu/ops/pallas/sa_pair.py:67-68) —
the grouped neighbourhoods are data in the training step.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from facl_tpu_torch.ops._launch import I, L, P, TRUNK, check_pool, \
    check_x, grid, launch, need, need_aligned, on_cpu, ptr, reduce, \
    stream_of
from facl_tpu_torch.ops.fused_sa import SALayerParams
from facl_tpu_torch.ops.sa_bwd import _fold_affine, _h_from_p, \
    _launch_sweep2, _layer1_terms, _layer_terms, _sweep2_plain
from facl_tpu_torch.ops.sa_fwd import _finalize, _moments_from_gram


# -- plain twins --------------------------------------------------------

def _rows(x3: torch.Tensor) -> torch.Tensor:
    """(B, C0, N) channel-major -> (B*N, C0) rows."""
    return x3.transpose(1, 2).reshape(-1, x3.shape[1])


def _h1_plain(x3, w1, b1, mul1, shift1):
    return _h_from_p(_rows(x3) @ w1 + b1, mul1, shift1)


def sa_fwd_layer12_plain(x3, w1, b1, mul1, shift1, w2, b2):
    """-> (p2 (R, C2), sum p2 (C2,), sum p2^2 (C2,))."""
    p2 = _h1_plain(x3, w1, b1, mul1, shift1) @ w2 + b2
    return p2, p2.sum(0), (p2 * p2).sum(0)


def _first_index(pg, v, pool):
    """First in-group row index where pg (P, pool, C) equals v (P, C)."""
    io = torch.arange(pool, device=pg.device).view(1, pool, 1)
    return torch.where(pg == v[:, None, :], io, pool).amin(1).to(torch.int32)


def sa_fwd_gram_pool_plain(p2, mul2, shift2, w3, b3, pool: int):
    """-> (Gram(h2), colsum(h2), max p3, min p3 (P, C3), first index of
    each (P, C3) int32)."""
    h2 = _h_from_p(p2, mul2, shift2)
    p3 = (h2 @ w3 + b3).reshape(-1, pool, w3.shape[1])
    mx, mn = p3.amax(1), p3.amin(1)
    return (h2.T @ h2, h2.sum(0), mx, mn, _first_index(p3, mx, pool),
            _first_index(p3, mn, pool))


def _dy3(dpooled, idx, pool):
    io = torch.arange(pool, device=idx.device).view(1, pool, 1)
    sel = io == idx[:, None, :].long()
    dy3 = torch.where(sel, dpooled[:, None, :], 0.0)
    return dy3.reshape(-1, dpooled.shape[1])


def sa_bwd_sweep1_plain(p2, mul2, shift2, dpooled, idx, gi3, w3, pool: int):
    """-> (A3 = dy3^T h2 (C3, C2), u3 = sum dy3 (C3,), q3 (R, C2))."""
    h2 = _h_from_p(p2, mul2, shift2)
    dy3 = _dy3(dpooled, idx, pool)
    return dy3.T @ h2, dy3.sum(0), (dy3 * gi3) @ w3.T


def sa_bwd_sweep2_plain(x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3,
                        M3, rc3, gi2, w2):
    """-> (A2 = dy2^T h1, G1 = h1^T h1, u2, ch1, mq (R, C1))."""
    h1 = _h1_plain(x3, w1, b1, mul1, shift1)
    h2 = _h_from_p(p2, mul2, shift2)
    dy2 = torch.where(h2 > 0, q3 - h2 @ M3 - rc3, 0.0)
    q2 = (dy2 * gi2) @ w2.T
    mq = torch.where(h1 > 0, q2, 0.0)
    return dy2.T @ h1, h1.T @ h1, dy2.sum(0), h1.sum(0), mq


def sa_bwd_sweep2_full_plain(x3, w1, b1, mul1, shift1, p2, mul2, shift2,
                             q3, M3, rc3, gi2, w2):
    """-> the accumulators of ops/sa_bwd.py::_sweep2_plain by name, h1
    recomputed from x."""
    return _sweep2_plain(_rows(x3), _h1_plain(x3, w1, b1, mul1, shift1), p2,
                         mul2, shift2, q3, M3, rc3, gi2, w2)


def sa_bwd_sweep3_plain(x3, w1, b1, mul1, shift1, mq, M2, rc2):
    """-> (A1 = dy1^T x (C1, C0), u1 = sum dy1 (C1,))."""
    h1 = _h1_plain(x3, w1, b1, mul1, shift1)
    dy1 = torch.where(h1 > 0, mq - (h1 @ M2 + rc2), 0.0)
    return dy1.T @ _rows(x3), dy1.sum(0)


# -- kernel wrappers ----------------------------------------------------

def sa_fwd_layer12(x3, w1, b1, mul1, shift1, w2, b2):
    """B2 sweep A. x3 (B, C0, N) -> (p2 (B*N, 64), sum p2, sum p2^2)."""
    if on_cpu(x3):
        return sa_fwd_layer12_plain(x3, w1, b1, mul1, shift1, w2, b2)
    B, C0, N = check_x(x3)
    C1, C2 = TRUNK[0], TRUNK[1]
    need(w1, (C0, C1), "w1")
    need(w2, (C1, C2), "w2")
    need(b2, (C2,), "b2")
    vec1 = torch.cat([b1, mul1, shift1]).contiguous()
    need(vec1, (3 * C1,), "b1|mul1|shift1")
    R = B * N
    nblk = grid(x3, R)
    p2 = torch.empty((R, C2), dtype=torch.float32, device=x3.device)
    part = torch.empty((nblk, 2, C2), dtype=torch.float64,
                       device=x3.device)
    launch("sa_pair", "facl_sa_fwd_layer12",
           [P, I, I, I, P, P, P, P, P, P, I, P],
           ptr(x3), B, C0, N, ptr(w1), ptr(vec1), ptr(w2), ptr(b2), ptr(p2),
           ptr(part), nblk, stream_of(x3), what="sa_fwd_layer12")
    sa_fwd_layer12.launches += 1
    s = reduce(part)
    return p2, s[0], s[1]


def sa_fwd_gram_pool(p2, mul2, shift2, w3, b3, pool: int):
    """B2 sweep B. -> (Gram(h2), colsum(h2), max, min, argmax, argmin)."""
    if on_cpu(p2):
        return sa_fwd_gram_pool_plain(p2, mul2, shift2, w3, b3, pool)
    R = p2.shape[0]
    C2, C3 = TRUNK[1], TRUNK[2]
    need(p2, (R, C2), "p2")
    need(w3, (C2, C3), "w3")
    need(b3, (C3,), "b3")
    check_pool(R, pool)
    need_aligned(p2, "p2")
    vec2 = torch.cat([mul2, shift2]).contiguous()
    need(vec2, (2 * C2,), "mul2|shift2")
    nblk = grid(p2, R, per_sm=1)
    dev, Pn = p2.device, R // pool
    partG = torch.empty((nblk, C2, C2), dtype=torch.float64, device=dev)
    partc = torch.empty((nblk, C2), dtype=torch.float64, device=dev)
    mx = torch.empty((Pn, C3), dtype=torch.float32, device=dev)
    mn = torch.empty_like(mx)
    imx = torch.empty((Pn, C3), dtype=torch.int32, device=dev)
    imn = torch.empty_like(imx)
    launch("sa_pair", "facl_sa_fwd_gram_pool",
           [P, L, I, P, P, P, P, P, P, P, P, P, I, P],
           ptr(p2), R, pool, ptr(vec2), ptr(w3), ptr(b3), ptr(partG),
           ptr(partc), ptr(mx), ptr(mn), ptr(imx), ptr(imn), nblk,
           stream_of(p2), what="sa_fwd_gram_pool")
    sa_fwd_gram_pool.launches += 1
    return reduce(partG), reduce(partc), mx, mn, imx, imn


def sa_bwd_sweep1(p2, mul2, shift2, dpooled, idx, gi3, w3, pool: int):
    """B3 sweep 1. -> (A3 (C3, C2), u3 (C3,), q3 (R, C2))."""
    if on_cpu(p2):
        return sa_bwd_sweep1_plain(p2, mul2, shift2, dpooled, idx, gi3, w3,
                                   pool)
    R = p2.shape[0]
    C2, C3 = TRUNK[1], TRUNK[2]
    check_pool(R, pool)
    need(p2, (R, C2), "p2")
    need(dpooled, (R // pool, C3), "dpooled")
    need(idx, (R // pool, C3), "idx", torch.int32)
    need(gi3, (C3,), "gi3")
    need(w3, (C2, C3), "w3")
    need_aligned(p2, "p2")
    need_aligned(dpooled, "dpooled")
    need_aligned(idx, "idx")
    vec2 = torch.cat([mul2, shift2]).contiguous()
    need(vec2, (2 * C2,), "mul2|shift2")
    nblk = grid(p2, R, per_sm=1)
    dev = p2.device
    q3 = torch.empty((R, C2), dtype=torch.float32, device=dev)
    partA = torch.empty((nblk, C3, C2), dtype=torch.float64, device=dev)
    partu = torch.empty((nblk, C3), dtype=torch.float64, device=dev)
    launch("sa_pair", "facl_sa_bwd_sweep1",
           [P, L, I, P, P, P, P, P, P, P, P, I, P],
           ptr(p2), R, pool, ptr(vec2), ptr(dpooled), ptr(idx), ptr(gi3),
           ptr(w3), ptr(q3), ptr(partA), ptr(partu), nblk, stream_of(p2),
           what="sa_bwd_sweep1")
    sa_bwd_sweep1.launches += 1
    return reduce(partA), reduce(partu), q3


def sa_bwd_sweep2(x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3, M3, rc3,
                  gi2, w2):
    """B3 sweep 2. -> (A2 (C2, C1), G1 (C1, C1), u2, ch1, mq (R, C1))."""
    if on_cpu(x3):
        return sa_bwd_sweep2_plain(x3, w1, b1, mul1, shift1, p2, mul2,
                                   shift2, q3, M3, rc3, gi2, w2)
    B, C0, N = check_x(x3)
    C1, C2 = TRUNK[0], TRUNK[1]
    R = B * N
    need(w1, (C0, C1), "w1")
    need(p2, (R, C2), "p2")
    need(q3, (R, C2), "q3")
    need(M3, (C2, C2), "M3")
    need(w2, (C1, C2), "w2")
    need_aligned(p2, "p2")
    need_aligned(q3, "q3")
    vec = torch.cat([b1, mul1, shift1, mul2, shift2, rc3, gi2]).contiguous()
    need(vec, (7 * C1,), "vectors")
    nblk = grid(x3, R, per_sm=1)
    dev = x3.device
    mq = torch.empty((R, C1), dtype=torch.float32, device=dev)
    partA = torch.empty((nblk, C2, C1), dtype=torch.float64, device=dev)
    partG = torch.empty((nblk, C1, C1), dtype=torch.float64, device=dev)
    partu = torch.empty((nblk, C2), dtype=torch.float64, device=dev)
    partc = torch.empty((nblk, C1), dtype=torch.float64, device=dev)
    launch("sa_pair", "facl_sa_bwd_sweep2",
           [P, I, I, I, P, P, P, P, P, P, P, P, P, P, P, I, P],
           ptr(x3), B, C0, N, ptr(w1), ptr(vec), ptr(p2), ptr(q3), ptr(M3),
           ptr(w2), ptr(mq), ptr(partA), ptr(partG), ptr(partu), ptr(partc),
           nblk, stream_of(x3), what="sa_bwd_sweep2")
    sa_bwd_sweep2.launches += 1
    return (reduce(partA), reduce(partG), reduce(partu), reduce(partc),
            mq)


def sa_bwd_sweep3(x3, w1, b1, mul1, shift1, mq, M2, rc2):
    """B3 sweep 3. -> (A1 (C1, C0), u1 (C1,))."""
    if on_cpu(x3):
        return sa_bwd_sweep3_plain(x3, w1, b1, mul1, shift1, mq, M2, rc2)
    B, C0, N = check_x(x3)
    C1 = TRUNK[0]
    R = B * N
    need(w1, (C0, C1), "w1")
    need(mq, (R, C1), "mq")
    need(M2, (C1, C1), "M2")
    need_aligned(mq, "mq")
    vec = torch.cat([b1, mul1, shift1, rc2]).contiguous()
    need(vec, (4 * C1,), "vectors")
    nblk = grid(x3, R, per_sm=1)
    part = torch.empty((nblk, C1, C0 + 1), dtype=torch.float64,
                       device=x3.device)
    launch("sa_pair", "facl_sa_bwd_sweep3",
           [P, I, I, I, P, P, P, P, P, I, P],
           ptr(x3), B, C0, N, ptr(w1), ptr(vec), ptr(mq), ptr(M2), ptr(part),
           nblk, stream_of(x3), what="sa_bwd_sweep3")
    sa_bwd_sweep3.launches += 1
    out = reduce(part)
    return out[:, :C0], out[:, C0]


def sa_bwd_sweep2_full(x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3, M3,
                       rc3, gi2, w2):
    """B6: sweep 2 of the non-slim backward. -> the accumulators of
    ops/sa_bwd.py::_sweep2_plain by name."""
    if on_cpu(x3):
        return sa_bwd_sweep2_full_plain(x3, w1, b1, mul1, shift1, p2, mul2,
                                        shift2, q3, M3, rc3, gi2, w2)
    B, C0, N = check_x(x3)
    out = _launch_sweep2(x3, B, C0, N, None, w1, b1, mul1, shift1, p2, mul2,
                         shift2, q3, M3, rc3, gi2, w2)
    sa_bwd_sweep2_full.launches += 1
    return out


KERNELS = (sa_fwd_layer12, sa_fwd_gram_pool, sa_bwd_sweep1, sa_bwd_sweep2,
           sa_bwd_sweep3, sa_bwd_sweep2_full)
for _k in KERNELS:
    _k.launches = 0


# -- the stage ----------------------------------------------------------

def sa_forward_pair(x3: torch.Tensor, layers: Sequence[SALayerParams],
                    pool: int, eps: float):
    """Forward of the stage. x3: (B, C0, N) channel-major rows, ``pool``
    consecutive rows per output row. Returns (pooled (R // pool, C3),
    stats [(mean, var)] x 3, residuals for :func:`sa_backward_pair`)."""
    lp1, lp2, lp3 = layers
    n = x3.shape[0] * x3.shape[2]
    Gx = torch.einsum("bcn,bdn->cd", x3, x3)
    cx = x3.sum((0, 2))
    mean1, var1 = _moments_from_gram(Gx, cx, lp1.kernel, lp1.bias, n)
    mul1, shift1 = _fold_affine(lp1, mean1, var1, eps)

    p2, s2, ss2 = sa_fwd_layer12(x3, lp1.kernel, lp1.bias, mul1, shift1,
                                 lp2.kernel, lp2.bias)
    mean2, var2 = _finalize(s2, ss2, n)
    mul2, shift2 = _fold_affine(lp2, mean2, var2, eps)

    G2, ch2, mx, mn, imx, imn = sa_fwd_gram_pool(p2, mul2, shift2,
                                                 lp3.kernel, lp3.bias, pool)
    mean3, var3 = _moments_from_gram(G2, ch2, lp3.kernel, lp3.bias, n)
    mul3, shift3 = _fold_affine(lp3, mean3, var3, eps)

    # Pool finalize by monotone commutation (facl_tpu/ops/pallas/
    # sa_pair.py:694-705): max of relu(p3*mul3 + shift3) comes from the
    # max row where mul3 >= 0 and from the min row where mul3 < 0. A dead
    # ReLU gets the sentinel pool.
    sel = mul3 >= 0
    zstar = torch.where(sel, mx, mn) * mul3 + shift3
    pooled = torch.relu(zstar)
    idx = torch.where(zstar > 0, torch.where(sel, imx, imn),
                      torch.full_like(imx, pool))
    stats = [(mean1, var1), (mean2, var2), (mean3, var3)]
    res = dict(Gx=Gx, cx=cx, p2=p2, G2=G2, ch2=ch2, idx=idx,
               mul1=mul1, shift1=shift1, mul2=mul2, shift2=shift2)
    return pooled, stats, res


def sa_backward_pair(x3, layers, stats, res, dpooled, pool: int,
                     eps: float, slim: bool = True):
    """The backward of the stage (facl_tpu/ops/pallas/sa_pair.py:711-947):
    B3's sweep 1, then the slim sweeps 2 and 3 (``slim``, pair3) or B6 and
    layer 1 in closed form from its third-order moments (pair). Returns
    ((dW, db, dgamma, dbeta) per layer)."""
    lp1, lp2, lp3 = layers
    (mean1, var1), (mean2, var2), (mean3, var3) = stats
    n = x3.shape[0] * x3.shape[2]
    gi2 = lp2.scale * torch.rsqrt(var2 + eps)
    gi3 = lp3.scale * torch.rsqrt(var3 + eps)
    mul1, shift1 = res["mul1"], res["shift1"]
    mul2, shift2 = res["mul2"], res["shift2"]

    A3, u3, q3 = sa_bwd_sweep1(res["p2"], mul2, shift2, dpooled.contiguous(),
                               res["idx"], gi3, lp3.kernel, pool)
    t3 = _layer_terms(A3, u3, lp3, mean3, var3, res["G2"], res["ch2"], n,
                      eps)
    args2 = (x3, lp1.kernel, lp1.bias, mul1, shift1, res["p2"], mul2, shift2,
             q3, t3["M"].contiguous(), t3["rc"], gi2, lp2.kernel)
    if slim:
        A2, G1, u2, ch1, mq = sa_bwd_sweep2(*args2)
        t2 = _layer_terms(A2, u2, lp2, mean2, var2, G1, ch1, n, eps)
        A1, u1 = sa_bwd_sweep3(x3, lp1.kernel, lp1.bias, mul1, shift1, mq,
                               t2["M"].contiguous(), t2["rc"])
        t1 = _layer_terms(A1, u1, lp1, mean1, var1, res["Gx"], res["cx"], n,
                          eps)
    else:
        m = sa_bwd_sweep2_full(*args2)
        t2 = _layer_terms(m["A2"], m["u2"], lp2, mean2, var2, m["G1"],
                          m["ch1"], n, eps)
        t1 = _layer1_terms(m, t2, lp1, mean1, var1, n, eps)
    return [(t["dW"], t["db"], t["dgamma"], t["dbeta"]) for t in (t1, t2, t3)]


class _Pair(torch.autograd.Function):
    """pooled, *stats = f(x_cf, eps, slim, *12 layer tensors). Stats carry
    no gradient (they feed the running-statistics update); the input
    cotangent is zero by contract."""

    @staticmethod
    def forward(ctx, x_cf, eps, slim, *flat):
        layers = [SALayerParams(*flat[4 * i:4 * i + 4]) for i in range(3)]
        Bv, C0, S, K = x_cf.shape
        x3 = x_cf.reshape(Bv, C0, S * K)
        pooled, stats, res = sa_forward_pair(x3, layers, K, eps)
        ctx.eps, ctx.pool, ctx.slim, ctx.x_shape = eps, K, slim, x_cf.shape
        keys = sorted(res)
        ctx.res_keys = keys
        ctx.save_for_backward(x3, *flat, *(m for s in stats for m in s),
                              *(res[k] for k in keys))
        flat_stats = [m for s in stats for m in s]
        ctx.mark_non_differentiable(*flat_stats)
        return (pooled.reshape(Bv, S, -1), *flat_stats)

    @staticmethod
    def backward(ctx, dpooled, *_):
        saved = ctx.saved_tensors
        x3 = saved[0]
        flat = saved[1:13]
        st = saved[13:19]
        res = dict(zip(ctx.res_keys, saved[19:]))
        layers = [SALayerParams(*flat[4 * i:4 * i + 4]) for i in range(3)]
        stats = [(st[0], st[1]), (st[2], st[3]), (st[4], st[5])]
        C3 = dpooled.shape[-1]
        grads = sa_backward_pair(x3, layers, stats, res,
                                 dpooled.reshape(-1, C3), ctx.pool, ctx.eps,
                                 ctx.slim)
        flat_grads = [g for layer in grads for g in layer]
        return (torch.zeros(ctx.x_shape, dtype=x3.dtype, device=x3.device),
                None, None, *flat_grads)


def sa_train_pair(x_cf: torch.Tensor, layers: Sequence[SALayerParams],
                  eps: float = 1e-5, slim: bool = False
                  ) -> Tuple[torch.Tensor, list]:
    """Train-mode SA stage on channel-major neighbourhoods x_cf (B, C0, S,
    K), max-pooled over K: ``sa_impl="pair"`` (B6 backward), or "pair3"
    with ``slim``. Returns (pooled (B, S, C3), [(mean, var)] x 3).
    Differentiable in every layer parameter; the input cotangent is ZERO."""
    if len(layers) != 3:
        raise ValueError("the pair stage is specialised to 3 layers")
    flat = [t for lp in layers for t in lp]
    out = _Pair.apply(x_cf.contiguous(), eps, slim, *flat)
    pooled, st = out[0], out[1:]
    return pooled, [(st[0], st[1]), (st[2], st[3]), (st[4], st[5])]


def sa_train_pair3(x_cf: torch.Tensor, layers: Sequence[SALayerParams],
                   eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, list]:
    """``sa_impl="pair3"``: :func:`sa_train_pair` with the slim 3-sweep
    backward (B3)."""
    return sa_train_pair(x_cf, layers, eps, slim=True)
