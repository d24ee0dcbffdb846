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

pair3 and pair also run at compute_dtype bfloat16 (``dtype=
torch.bfloat16``): the six sweeps then have bf16 forms
(``sa_fwd_layer12_bf16`` .. ``sa_bwd_sweep3_bf16`` and
``sa_bwd_sweep2_full_bf16``, entry points ``facl_sa_*_bf16``) that store x,
p2, q3 and mq (and B2b's max/min) in bf16: B2a, B2b, B3a, B3b and B3c as
kernels of their own on bf16 tensor cores (mma.sync m16n8k16 bf16; B3a's
dense q3 product as wgmma), B6 (csrc/sa_2sweep.cu) on CUDA cores. Their
twins define the cast points (below). Everything outside the sweeps stays
f32, as XLA keeps it outside Pallas.

Input cotangent contract: ZERO (facl_tpu/ops/pallas/sa_pair.py:67-68) —
the grouped neighbourhoods are data in the training step.

Under data parallelism (``mesh``, parallel/mesh.py) each rank runs the same
sweeps on its own block of the batch, and between the sweeps the
accumulators are summed over the ranks (B6s, the counterpart of
facl_tpu/ops/pallas/sa_pair.py::make_sharded_pair :1064-1156, whose
``jax.lax.psum``s over ``axis_name`` sit at :590-594 and :744-753): one
float64 all_reduce per barrier (parallel/collectives.py::psum_packed),
three in the forward (Gram(x) and colsum(x); the sums of p2 and p2^2;
Gram(h2) and colsum(h2)) and three in pair3's backward (A3, u3; A2, G1, u2,
ch1; A1, u1), two in pair's (A3, u3; B6's accumulators). The statistics
are then global, and so are the returned parameter gradients, the same on
every rank (JAX's ``out_specs=P()``): they must not be summed over the
ranks again. Row outputs (p2, the pool indices, the pooled rows) stay per
rank. "The ranks" are the mesh's dp group: under tensor parallelism
(``mp > 1``) the mp ranks of a dp block run the same sweeps on the same
rows, as JAX's ``shard_map`` over ``dp`` alone does.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from facl_tpu_torch.ops._launch import I, L, P, TRUNK, check_pool, \
    check_x, entry, grid, launch, need, need_aligned, on_cpu, ptr, reduce, \
    stream_of
from facl_tpu_torch.ops.fused_sa import SALayerParams
from facl_tpu_torch.ops.sa_bwd import BF16, _fold_affine, _h_bf16, \
    _h_from_p, _launch_sweep2, _layer1_terms, _layer_terms, _rb, \
    _sweep2_bf16, _sweep2_plain
from facl_tpu_torch.ops.sa_fwd import _finalize, _moments_from_gram
from facl_tpu_torch.parallel.collectives import psum_packed
from facl_tpu_torch.parallel.mesh import distributed


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


# -- bf16 twins ----------------------------------------------------------
# The same sweeps at compute_dtype bfloat16, as the TPU kernels trace them
# (facl_tpu/ops/pallas/sa_pair.py:121-494 at dtype=bfloat16): x, p2, q3
# and mq are stored in bf16; every product takes bf16 operands (the f32
# parameters rounded) and sums in f32 (preferred_element_type=f32); the
# results are rounded to bf16 at the kernels' cast points. Each twin is
# f32 arithmetic on bf16-rounded values, with one explicit rounding
# (``_rb``) per cast point: the JAX op chain up to summation order. A
# product of two bf16 values is exact in f32, so only the order of the
# sums differs from JAX and from the kernels. Where the JAX kernel adds
# two bf16 values and no cast or store follows (p1, p3, and p2 as its
# moment sums read it), XLA keeps the sum in f32 (its excess precision in
# a fused bf16 chain): checked against the kernels' interpret-mode
# outputs, tests/test_torch_bf16_sa.py.

def _h1_bf16(x3, w1, b1, mul1, shift1):
    """h1 (f32 holding bf16 values): p1 = bf16(x W1) + bf16(b1) summed in
    f32, h1 = relu(bf16(p1 mul1 + shift1)) (sa_pair.py:164-165,
    :316-330)."""
    p1 = _rb(_rows(x3).float() @ _rb(w1)) + _rb(b1)
    return _h_bf16(p1, mul1, shift1)


_h2_bf16 = _h_bf16


def sa_fwd_layer12_bf16_plain(x3, w1, b1, mul1, shift1, w2, b2):
    """-> (p2 (R, C2) bf16, sum p2, sum p2^2) with p2 = bf16(h1 W2) +
    bf16(b2): stored rounded to bf16, summed in f32 before that rounding
    (sa_pair.py:166-174)."""
    p2 = _rb(_h1_bf16(x3, w1, b1, mul1, shift1) @ _rb(w2)) + _rb(b2)
    return p2.to(BF16), p2.sum(0), (p2 * p2).sum(0)


def sa_fwd_gram_pool_bf16_plain(p2, mul2, shift2, w3, b3, pool: int):
    """-> (Gram(h2), colsum(h2) in f32; max, min (P, C3) of p3 =
    bf16(h2 W3) + bf16(b3) (in f32), stored as bf16; the first index of
    each, on the f32 p3) (sa_pair.py:220-247)."""
    h2 = _h2_bf16(p2, mul2, shift2)
    p3 = (_rb(h2 @ _rb(w3)) + _rb(b3)).reshape(-1, pool, w3.shape[1])
    mx, mn = p3.amax(1), p3.amin(1)
    return (h2.T @ h2, h2.sum(0), mx.to(BF16), mn.to(BF16),
            _first_index(p3, mx, pool), _first_index(p3, mn, pool))


def sa_bwd_sweep1_bf16_plain(p2, mul2, shift2, dpooled, idx, gi3, w3,
                             pool: int):
    """-> (A3, u3 in f32; q3 (R, C2) bf16 = bf16(bf16(dy3 bf16(gi3))
    bf16(W3)^T)); dpooled is the bf16 cotangent (sa_pair.py:283-292)."""
    h2 = _h2_bf16(p2, mul2, shift2)
    dy3 = _dy3(dpooled.float(), idx, pool)
    q3 = _rb(_rb(dy3 * _rb(gi3)) @ _rb(w3).T)
    return dy3.T @ h2, dy3.sum(0), q3.to(BF16)


def sa_bwd_sweep2_bf16_plain(x3, w1, b1, mul1, shift1, p2, mul2, shift2,
                             q3, M3, rc3, gi2, w2):
    """-> (A2 = bf16(dy2)^T h1, G1, u2 = sum dy2 (before its rounding),
    ch1, all f32; mq (R, C1) bf16) with dy2 = [h2 > 0] (q3 - bf16(h2
    bf16(M3)) - rc3) and q2 = bf16(bf16(bf16(dy2) bf16(gi2)) bf16(W2)^T)
    (sa_pair.py:436-456)."""
    h1 = _h1_bf16(x3, w1, b1, mul1, shift1)
    h2 = _h2_bf16(p2, mul2, shift2)
    dy2 = torch.where(h2 > 0, q3.float() - _rb(h2 @ _rb(M3)) - rc3, 0.0)
    dy2d = _rb(dy2)
    q2 = _rb(_rb(dy2d * _rb(gi2)) @ _rb(w2).T)
    mq = torch.where(h1 > 0, q2, 0.0)
    return dy2d.T @ h1, h1.T @ h1, dy2.sum(0), h1.sum(0), mq.to(BF16)


def sa_bwd_sweep3_bf16_plain(x3, w1, b1, mul1, shift1, mq, M2, rc2):
    """-> (A1 = dy1^T x, u1 = sum dy1) in f32, dy1 = bf16([h1 > 0] (mq -
    (bf16(h1 bf16(M2)) + rc2))) (sa_pair.py:476-494)."""
    h1 = _h1_bf16(x3, w1, b1, mul1, shift1)
    dy1 = _rb(torch.where(h1 > 0, mq.float() - (_rb(h1 @ _rb(M2)) + rc2),
                          0.0))
    return dy1.T @ _rows(x3).float(), dy1.sum(0)


def sa_bwd_sweep2_full_bf16_plain(x3, w1, b1, mul1, shift1, p2, mul2,
                                  shift2, q3, M3, rc3, gi2, w2):
    """B6 at bf16 (sa_pair.py:333-400): the accumulators of
    ops/sa_bwd.py::_sweep2_bf16 by name, h1 recomputed from the bf16 x by
    the chain of the bf16 forward (``_h1_bf16``)."""
    return _sweep2_bf16(_rows(x3).float(), _h1_bf16(x3, w1, b1, mul1, shift1),
                        p2, mul2, shift2, q3, M3, rc3, gi2, w2)


# -- kernel wrappers ----------------------------------------------------
# Each sweep has an f32 and a bf16 entry point (csrc/sa_pair.cu:
# facl_sa_*, facl_sa_*_bf16; two kernels each), each with its own
# wrapper, twin and launch counter. ``dt`` is the storage dtype of x,
# p2, q3 and mq, and of the max/min of B2b; a tensor stored otherwise
# raises.

def _layer12(x3, w1, b1, mul1, shift1, w2, b2, dt):
    B, C0, N = check_x(x3, dt)
    C1, C2 = TRUNK[0], TRUNK[1]
    need(w1, (C0, C1), "w1")
    need(w2, (C1, C2), "w2")
    need(b2, (C2,), "b2")
    need_aligned(x3, "x")
    vec1 = torch.cat([b1, mul1, shift1]).contiguous()
    need(vec1, (3 * C1,), "b1|mul1|shift1")
    R = B * N
    nblk = grid(x3, R, per_sm=1)
    p2 = torch.empty((R, C2), dtype=dt, device=x3.device)
    part = torch.empty((nblk, 2, C2), dtype=torch.float64,
                       device=x3.device)
    launch("sa_pair", entry("fwd_layer12", dt),
           [P, I, I, I, P, P, P, P, P, P, I, P],
           ptr(x3), B, C0, N, ptr(w1), ptr(vec1), ptr(w2), ptr(b2), ptr(p2),
           ptr(part), nblk, stream_of(x3), what=entry("fwd_layer12", dt))
    s = reduce(part)
    return p2, s[0], s[1]


def _gram_pool(p2, mul2, shift2, w3, b3, pool, dt):
    R = p2.shape[0]
    C2, C3 = TRUNK[1], TRUNK[2]
    need(p2, (R, C2), "p2", dt)
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
    mx = torch.empty((Pn, C3), dtype=dt, device=dev)
    mn = torch.empty_like(mx)
    imx = torch.empty((Pn, C3), dtype=torch.int32, device=dev)
    imn = torch.empty_like(imx)
    launch("sa_pair", entry("fwd_gram_pool", dt),
           [P, L, I, P, P, P, P, P, P, P, P, P, I, P],
           ptr(p2), R, pool, ptr(vec2), ptr(w3), ptr(b3), ptr(partG),
           ptr(partc), ptr(mx), ptr(mn), ptr(imx), ptr(imn), nblk,
           stream_of(p2), what=entry("fwd_gram_pool", dt))
    return reduce(partG), reduce(partc), mx, mn, imx, imn


def _sweep1(p2, mul2, shift2, dpooled, idx, gi3, w3, pool, dt):
    R = p2.shape[0]
    C2, C3 = TRUNK[1], TRUNK[2]
    check_pool(R, pool)
    need(p2, (R, C2), "p2", dt)
    need(dpooled, (R // pool, C3), "dpooled", dt)
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
    q3 = torch.empty((R, C2), dtype=dt, device=dev)
    partA = torch.empty((nblk, C3, C2), dtype=torch.float64, device=dev)
    partu = torch.empty((nblk, C3), dtype=torch.float64, device=dev)
    launch("sa_pair", entry("bwd_sweep1", dt),
           [P, L, I, P, P, P, P, P, P, P, P, I, P],
           ptr(p2), R, pool, ptr(vec2), ptr(dpooled), ptr(idx), ptr(gi3),
           ptr(w3), ptr(q3), ptr(partA), ptr(partu), nblk, stream_of(p2),
           what=entry("bwd_sweep1", dt))
    return reduce(partA), reduce(partu), q3


def _sweep2(x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3, M3, rc3, gi2,
            w2, dt):
    B, C0, N = check_x(x3, dt)
    C1, C2 = TRUNK[0], TRUNK[1]
    R = B * N
    need(w1, (C0, C1), "w1")
    need(p2, (R, C2), "p2", dt)
    need(q3, (R, C2), "q3", dt)
    need(M3, (C2, C2), "M3")
    need(w2, (C1, C2), "w2")
    need_aligned(p2, "p2")
    need_aligned(q3, "q3")
    vec = torch.cat([b1, mul1, shift1, mul2, shift2, rc3, gi2]).contiguous()
    need(vec, (7 * C1,), "vectors")
    nblk = grid(x3, R, per_sm=1)
    dev = x3.device
    mq = torch.empty((R, C1), dtype=dt, device=dev)
    partA = torch.empty((nblk, C2, C1), dtype=torch.float64, device=dev)
    partG = torch.empty((nblk, C1, C1), dtype=torch.float64, device=dev)
    partu = torch.empty((nblk, C2), dtype=torch.float64, device=dev)
    partc = torch.empty((nblk, C1), dtype=torch.float64, device=dev)
    launch("sa_pair", entry("bwd_sweep2", dt),
           [P, I, I, I, P, P, P, P, P, P, P, P, P, P, P, I, P],
           ptr(x3), B, C0, N, ptr(w1), ptr(vec), ptr(p2), ptr(q3), ptr(M3),
           ptr(w2), ptr(mq), ptr(partA), ptr(partG), ptr(partu), ptr(partc),
           nblk, stream_of(x3), what=entry("bwd_sweep2", dt))
    return (reduce(partA), reduce(partG), reduce(partu), reduce(partc),
            mq)


def _sweep3(x3, w1, b1, mul1, shift1, mq, M2, rc2, dt):
    B, C0, N = check_x(x3, dt)
    C1 = TRUNK[0]
    R = B * N
    need(w1, (C0, C1), "w1")
    need(mq, (R, C1), "mq", dt)
    need(M2, (C1, C1), "M2")
    need_aligned(mq, "mq")
    vec = torch.cat([b1, mul1, shift1, rc2]).contiguous()
    need(vec, (4 * C1,), "vectors")
    nblk = grid(x3, R, per_sm=1)
    part = torch.empty((nblk, C1, C0 + 1), dtype=torch.float64,
                       device=x3.device)
    launch("sa_pair", entry("bwd_sweep3", dt),
           [P, I, I, I, P, P, P, P, P, I, P],
           ptr(x3), B, C0, N, ptr(w1), ptr(vec), ptr(mq), ptr(M2), ptr(part),
           nblk, stream_of(x3), what=entry("bwd_sweep3", dt))
    out = reduce(part)
    return out[:, :C0], out[:, C0]


def sa_fwd_layer12(x3, w1, b1, mul1, shift1, w2, b2):
    """B2 sweep A. x3 (B, C0, N) -> (p2 (B*N, 64), sum p2, sum p2^2).
    The kernel stages x by 16-byte TMA copies: a CUDA x3 that is not
    16-byte aligned raises."""
    if on_cpu(x3):
        return sa_fwd_layer12_plain(x3, w1, b1, mul1, shift1, w2, b2)
    out = _layer12(x3, w1, b1, mul1, shift1, w2, b2, torch.float32)
    sa_fwd_layer12.launches += 1
    return out


def sa_fwd_gram_pool(p2, mul2, shift2, w3, b3, pool: int):
    """B2 sweep B. -> (Gram(h2), colsum(h2), max, min, argmax, argmin)."""
    if on_cpu(p2):
        return sa_fwd_gram_pool_plain(p2, mul2, shift2, w3, b3, pool)
    out = _gram_pool(p2, mul2, shift2, w3, b3, pool, torch.float32)
    sa_fwd_gram_pool.launches += 1
    return out


def sa_bwd_sweep1(p2, mul2, shift2, dpooled, idx, gi3, w3, pool: int):
    """B3 sweep 1. -> (A3 (C3, C2), u3 (C3,), q3 (R, C2))."""
    if on_cpu(p2):
        return sa_bwd_sweep1_plain(p2, mul2, shift2, dpooled, idx, gi3, w3,
                                   pool)
    out = _sweep1(p2, mul2, shift2, dpooled, idx, gi3, w3, pool,
                  torch.float32)
    sa_bwd_sweep1.launches += 1
    return out


def sa_bwd_sweep2(x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3, M3, rc3,
                  gi2, w2):
    """B3 sweep 2. -> (A2 (C2, C1), G1 (C1, C1), u2, ch1, mq (R, C1))."""
    if on_cpu(x3):
        return sa_bwd_sweep2_plain(x3, w1, b1, mul1, shift1, p2, mul2,
                                   shift2, q3, M3, rc3, gi2, w2)
    out = _sweep2(x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3, M3, rc3,
                  gi2, w2, torch.float32)
    sa_bwd_sweep2.launches += 1
    return out


def sa_bwd_sweep3(x3, w1, b1, mul1, shift1, mq, M2, rc2):
    """B3 sweep 3. -> (A1 (C1, C0), u1 (C1,))."""
    if on_cpu(x3):
        return sa_bwd_sweep3_plain(x3, w1, b1, mul1, shift1, mq, M2, rc2)
    out = _sweep3(x3, w1, b1, mul1, shift1, mq, M2, rc2, torch.float32)
    sa_bwd_sweep3.launches += 1
    return out


def sa_fwd_layer12_bf16(x3, w1, b1, mul1, shift1, w2, b2):
    """B2 sweep A at bf16: x3 (B, C0, N) bf16 -> (p2 (B*N, 64) bf16, sum
    p2, sum p2^2 in f32)."""
    if on_cpu(x3):
        return sa_fwd_layer12_bf16_plain(x3, w1, b1, mul1, shift1, w2, b2)
    out = _layer12(x3, w1, b1, mul1, shift1, w2, b2, BF16)
    sa_fwd_layer12_bf16.launches += 1
    return out


def sa_fwd_gram_pool_bf16(p2, mul2, shift2, w3, b3, pool: int):
    """B2 sweep B at bf16: p2 bf16 -> (Gram(h2), colsum(h2) in f32, max,
    min bf16, argmax, argmin)."""
    if on_cpu(p2):
        return sa_fwd_gram_pool_bf16_plain(p2, mul2, shift2, w3, b3, pool)
    out = _gram_pool(p2, mul2, shift2, w3, b3, pool, BF16)
    sa_fwd_gram_pool_bf16.launches += 1
    return out


def sa_bwd_sweep1_bf16(p2, mul2, shift2, dpooled, idx, gi3, w3, pool: int):
    """B3 sweep 1 at bf16: p2, dpooled bf16 -> (A3, u3 in f32, q3 bf16)."""
    if on_cpu(p2):
        return sa_bwd_sweep1_bf16_plain(p2, mul2, shift2, dpooled, idx, gi3,
                                        w3, pool)
    out = _sweep1(p2, mul2, shift2, dpooled, idx, gi3, w3, pool, BF16)
    sa_bwd_sweep1_bf16.launches += 1
    return out


def sa_bwd_sweep2_bf16(x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3, M3,
                       rc3, gi2, w2):
    """B3 sweep 2 at bf16: x, p2, q3 bf16 -> (A2, G1, u2, ch1 in f32, mq
    bf16)."""
    if on_cpu(x3):
        return sa_bwd_sweep2_bf16_plain(x3, w1, b1, mul1, shift1, p2, mul2,
                                        shift2, q3, M3, rc3, gi2, w2)
    out = _sweep2(x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3, M3, rc3,
                  gi2, w2, BF16)
    sa_bwd_sweep2_bf16.launches += 1
    return out


def sa_bwd_sweep3_bf16(x3, w1, b1, mul1, shift1, mq, M2, rc2):
    """B3 sweep 3 at bf16: x, mq bf16 -> (A1, u1) in f32."""
    if on_cpu(x3):
        return sa_bwd_sweep3_bf16_plain(x3, w1, b1, mul1, shift1, mq, M2,
                                        rc2)
    out = _sweep3(x3, w1, b1, mul1, shift1, mq, M2, rc2, BF16)
    sa_bwd_sweep3_bf16.launches += 1
    return out


def _sweep2_full(x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3, M3, rc3,
                 gi2, w2, dt):
    B, C0, N = check_x(x3, dt)
    return _launch_sweep2(x3, B, C0, N, None, w1, b1, mul1, shift1, p2, mul2,
                          shift2, q3, M3, rc3, gi2, w2, dt)


def sa_bwd_sweep2_full(x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3, M3,
                       rc3, gi2, w2):
    """B6: sweep 2 of the non-slim backward. -> the accumulators of
    ops/sa_bwd.py::_sweep2_sums by name."""
    if on_cpu(x3):
        return sa_bwd_sweep2_full_plain(x3, w1, b1, mul1, shift1, p2, mul2,
                                        shift2, q3, M3, rc3, gi2, w2)
    out = _sweep2_full(x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3, M3,
                       rc3, gi2, w2, torch.float32)
    sa_bwd_sweep2_full.launches += 1
    return out


def sa_bwd_sweep2_full_bf16(x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3,
                            M3, rc3, gi2, w2):
    """B6 at bf16: x, p2, q3 bf16 -> the accumulators in f32."""
    if on_cpu(x3):
        return sa_bwd_sweep2_full_bf16_plain(x3, w1, b1, mul1, shift1, p2,
                                             mul2, shift2, q3, M3, rc3, gi2,
                                             w2)
    out = _sweep2_full(x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3, M3,
                       rc3, gi2, w2, BF16)
    sa_bwd_sweep2_full_bf16.launches += 1
    return out


KERNELS = (sa_fwd_layer12, sa_fwd_gram_pool, sa_bwd_sweep1, sa_bwd_sweep2,
           sa_bwd_sweep3, sa_bwd_sweep2_full, sa_fwd_layer12_bf16,
           sa_fwd_gram_pool_bf16, sa_bwd_sweep1_bf16, sa_bwd_sweep2_bf16,
           sa_bwd_sweep3_bf16, sa_bwd_sweep2_full_bf16)
for _k in KERNELS:
    _k.launches = 0


def _sweeps(dtype):
    """pair3's five sweeps and pair's B6 at ``dtype``: the bf16 ones, or
    the f32 ones for any other dtype (the module's names, read at call
    time)."""
    if dtype == BF16:
        return (sa_fwd_layer12_bf16, sa_fwd_gram_pool_bf16,
                sa_bwd_sweep1_bf16, sa_bwd_sweep2_bf16, sa_bwd_sweep3_bf16,
                sa_bwd_sweep2_full_bf16)
    return (sa_fwd_layer12, sa_fwd_gram_pool, sa_bwd_sweep1, sa_bwd_sweep2,
            sa_bwd_sweep3, sa_bwd_sweep2_full)


# -- the stage ----------------------------------------------------------

def _rows_n(x3: torch.Tensor, mesh) -> int:
    """The BatchNorm row count: this rank's rows times the ranks
    (facl_tpu/ops/pallas/sa_pair.py:591, ``R * psum(1)``)."""
    n = x3.shape[0] * x3.shape[2]
    return n * mesh.dp if distributed(mesh) else n


def sa_forward_pair(x3: torch.Tensor, layers: Sequence[SALayerParams],
                    pool: int, eps: float, dtype=torch.float32, mesh=None):
    """Forward of the stage. x3: (B, C0, N) channel-major rows, ``pool``
    consecutive rows per output row, stored in ``dtype`` (bf16 runs the
    bf16 sweeps; any other dtype the f32 form). With ``mesh`` the BatchNorm
    statistics are over every rank's rows (module docstring). Returns
    (pooled (R // pool, C3) in x3's dtype, stats [(mean, var)] x 3 in f32,
    residuals for :func:`sa_backward_pair`)."""
    bf = dtype == BF16
    fwd12, gram_pool = _sweeps(dtype)[:2]
    lp1, lp2, lp3 = layers
    n = _rows_n(x3, mesh)
    # The layer-1 moments from Gram(x) in f32 (of the bf16 x at bf16), as
    # XLA computes them outside the kernels (sa_pair.py:601-632).
    xg = x3.float() if bf else x3
    Gx, cx = psum_packed([torch.einsum("bcn,bdn->cd", xg, xg),
                          xg.sum((0, 2))], mesh)
    mean1, var1 = _moments_from_gram(Gx, cx, lp1.kernel, lp1.bias, n)
    mul1, shift1 = _fold_affine(lp1, mean1, var1, eps)

    p2, s2, ss2 = fwd12(x3, lp1.kernel, lp1.bias, mul1, shift1, lp2.kernel,
                        lp2.bias)
    s2, ss2 = psum_packed([s2, ss2], mesh)
    mean2, var2 = _finalize(s2, ss2, n)
    mul2, shift2 = _fold_affine(lp2, mean2, var2, eps)

    G2, ch2, mx, mn, imx, imn = gram_pool(p2, mul2, shift2, lp3.kernel,
                                          lp3.bias, pool)
    G2, ch2 = psum_packed([G2, ch2], mesh)
    mean3, var3 = _moments_from_gram(G2, ch2, lp3.kernel, lp3.bias, n)
    mul3, shift3 = _fold_affine(lp3, mean3, var3, eps)

    # Pool finalize by monotone commutation (facl_tpu/ops/pallas/
    # sa_pair.py:694-705): max of relu(p3*mul3 + shift3) comes from the
    # max row where mul3 >= 0 and from the min row where mul3 < 0. A dead
    # ReLU gets the sentinel pool. At bf16 the affine runs in f32 on the
    # bf16 extrema and is rounded before the ReLU.
    if bf:
        mx, mn = mx.float(), mn.float()
    sel = mul3 >= 0
    zstar = torch.where(sel, mx, mn) * mul3 + shift3
    pooled = torch.relu(zstar.to(BF16) if bf else zstar)
    idx = torch.where(zstar > 0, torch.where(sel, imx, imn),
                      torch.full_like(imx, pool))
    stats = [(mean1, var1), (mean2, var2), (mean3, var3)]
    res = dict(Gx=Gx, cx=cx, p2=p2, G2=G2, ch2=ch2, idx=idx,
               mul1=mul1, shift1=shift1, mul2=mul2, shift2=shift2)
    return pooled, stats, res


def sa_backward_pair(x3, layers, stats, res, dpooled, pool: int,
                     eps: float, slim: bool = True, dtype=torch.float32,
                     mesh=None):
    """The backward of the stage (facl_tpu/ops/pallas/sa_pair.py:711-947):
    B3's sweep 1, then the slim sweeps 2 and 3 (``slim``, pair3) or B6 and
    layer 1 in closed form from its third-order moments (pair). At bf16
    the bf16 sweeps, dpooled the bf16 cotangent. With
    ``mesh`` each sweep's accumulators are summed over the ranks before
    the layer algebra reads them, so the gradients are global. Returns
    ((dW, db, dgamma, dbeta) per layer) in f32."""
    _, _, sweep1, sweep2, sweep3, sweep2_full = _sweeps(dtype)
    lp1, lp2, lp3 = layers
    (mean1, var1), (mean2, var2), (mean3, var3) = stats
    n = _rows_n(x3, mesh)
    gi2 = lp2.scale * torch.rsqrt(var2 + eps)
    gi3 = lp3.scale * torch.rsqrt(var3 + eps)
    mul1, shift1 = res["mul1"], res["shift1"]
    mul2, shift2 = res["mul2"], res["shift2"]

    A3, u3, q3 = sweep1(res["p2"], mul2, shift2, dpooled.contiguous(),
                        res["idx"], gi3, lp3.kernel, pool)
    A3, u3 = psum_packed([A3, u3], mesh)
    t3 = _layer_terms(A3, u3, lp3, mean3, var3, res["G2"], res["ch2"], n,
                      eps)
    args2 = (x3, lp1.kernel, lp1.bias, mul1, shift1, res["p2"], mul2, shift2,
             q3, t3["M"].contiguous(), t3["rc"], gi2, lp2.kernel)
    if slim:
        A2, G1, u2, ch1, mq = sweep2(*args2)
        A2, G1, u2, ch1 = psum_packed([A2, G1, u2, ch1], mesh)
        t2 = _layer_terms(A2, u2, lp2, mean2, var2, G1, ch1, n, eps)
        A1, u1 = sweep3(x3, lp1.kernel, lp1.bias, mul1, shift1, mq,
                        t2["M"].contiguous(), t2["rc"])
        A1, u1 = psum_packed([A1, u1], mesh)
        t1 = _layer_terms(A1, u1, lp1, mean1, var1, res["Gx"], res["cx"], n,
                          eps)
    else:
        m = sweep2_full(*args2)
        m = dict(zip(m, psum_packed(list(m.values()), mesh)))
        t2 = _layer_terms(m["A2"], m["u2"], lp2, mean2, var2, m["G1"],
                          m["ch1"], n, eps)
        t1 = _layer1_terms(m, t2, lp1, mean1, var1, n, eps)
    return [(t["dW"], t["db"], t["dgamma"], t["dbeta"]) for t in (t1, t2, t3)]


class _Pair(torch.autograd.Function):
    """pooled, *stats = f(x_cf, eps, slim, dtype, mesh, *12 layer tensors).
    Stats carry no gradient (they feed the running-statistics update); the
    input cotangent is zero by contract."""

    @staticmethod
    def forward(ctx, x_cf, eps, slim, dtype, mesh, *flat):
        layers = [SALayerParams(*flat[4 * i:4 * i + 4]) for i in range(3)]
        Bv, C0, S, K = x_cf.shape
        x3 = x_cf.reshape(Bv, C0, S * K)
        pooled, stats, res = sa_forward_pair(x3, layers, K, eps, dtype, mesh)
        ctx.eps, ctx.pool, ctx.slim, ctx.x_shape = eps, K, slim, x_cf.shape
        ctx.dtype, ctx.mesh = dtype, mesh
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
                                 ctx.slim, ctx.dtype, ctx.mesh)
        flat_grads = [g for layer in grads for g in layer]
        return (torch.zeros(ctx.x_shape, dtype=x3.dtype, device=x3.device),
                None, None, None, None, *flat_grads)


def sa_train_pair(x_cf: torch.Tensor, layers: Sequence[SALayerParams],
                  eps: float = 1e-5, slim: bool = False,
                  dtype=torch.float32, mesh=None
                  ) -> Tuple[torch.Tensor, list]:
    """Train-mode SA stage on channel-major neighbourhoods x_cf (B, C0, S,
    K), max-pooled over K: ``sa_impl="pair"`` (B6 backward), or "pair3"
    with ``slim``. ``dtype=torch.bfloat16`` runs the bf16 sweeps on x_cf
    cast to bf16; the pooled output is then bf16. With ``mesh`` x_cf is
    this rank's block and the statistics and parameter gradients are
    global (B6s, module docstring); the rank's
    batch row count must be even, as make_sharded_pair asks
    (facl_tpu/ops/pallas/sa_pair.py:1121-1138). Returns (pooled
    (B, S, C3), [(mean, var)] x 3). Differentiable in every layer
    parameter; the input cotangent is ZERO."""
    if len(layers) != 3:
        raise ValueError("the pair stage is specialised to 3 layers")
    if distributed(mesh) and x_cf.shape[0] % 2:
        raise ValueError(f"pair stage under dp={mesh.dp}: this rank's "
                         f"batch row count {x_cf.shape[0]} must be even")
    if dtype == BF16:
        x_cf = x_cf.to(BF16)
    flat = [t for lp in layers for t in lp]
    out = _Pair.apply(x_cf.contiguous(), eps, slim, dtype, mesh, *flat)
    pooled, st = out[0], out[1:]
    return pooled, [(st[0], st[1]), (st[2], st[3]), (st[4], st[5])]


def sa_train_pair3(x_cf: torch.Tensor, layers: Sequence[SALayerParams],
                   eps: float = 1e-5, dtype=torch.float32, mesh=None
                   ) -> Tuple[torch.Tensor, list]:
    """``sa_impl="pair3"``: :func:`sa_train_pair` with the slim 3-sweep
    backward (B3)."""
    return sa_train_pair(x_cf, layers, eps, slim=True, dtype=dtype,
                         mesh=mesh)
