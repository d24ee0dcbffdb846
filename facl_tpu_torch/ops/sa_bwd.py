"""The two-sweep SA backward: kernel B8 and ``sa_impl="hybrid"``
(counterpart of facl_tpu/ops/pallas/sa_bwd.py), plus the host algebra
every SA backward shares (sa_bwd.py:56-67,198-229), in float32.

The backward reads the stored pre-activations p1, p2 and recomputes the
hidden activations from them with each layer's folded affine:

  B8a sa_bwd2_sweep1   recompute the top layer per tile, split each pooled
                       cotangent evenly among its group's exact ties;
                       A3 = dy3^T h2, u3, Gram(h2), colsum(h2); q3 rows
  B8b sa_bwd2_sweep2   dy2 = [h2 > 0] (q3 - h2 M3 - rc3) and layer 1 in
                       third-order-moment form: A2, G1, TM1, U1, P1, T1x,
                       cnt1, acc1, Gx, cx (h1 from the stored p1)

Layer 1 then follows in closed form (``_layer1_terms``). Each sweep has a
CUDA kernel (``csrc/sa_2sweep.cu``) and a plain PyTorch twin; a CPU tensor
takes the twin, a CUDA tensor launches the kernel or raises, and each
wrapper counts its launches in ``<wrapper>.launches``. Every host
contraction is a tiny (<= 256-wide) matrix with O(rows) entries; with
TF32 off (facl_tpu_torch/__init__.py) they run in full f32 on the card,
as the JAX side forces Precision.HIGHEST.

Pool ties follow this kernel's rule (sa_bwd.py:70-91), not pair3's: the
max is taken on the sweep's own recomputed f32 relu(z), and dpooled is
split evenly among exact ties where z > 0. B8a recomputes p3 on the
tensor cores in its own order (the forward's comes from a cuBLAS product
in ``hybrid``, from B7c's k-order CUDA-core sums in ``hybrid2``), so at
near-ties the backward may route to another row than the one the forward
pooled — as in JAX (sa_bwd.py:30-35). Its wrapper launches one 512-thread
block an SM and takes a 16-byte aligned p2 (its tiles arrive by TMA bulk
copies). B8b at f32 (also B6's, ops/sa_pair.py) runs its products on the
TF32 tensor cores in 3xTF32 (wgmma), one 512-thread block an SM over
64-row steps; its f32 sums, each k8 step of rows added round-to-nearest,
go to the float64 partials every 128 steps, so only the order of the sums
differs from the twin's, and it takes rows at any 4-byte alignment.

At compute_dtype bfloat16 (``dtype=torch.bfloat16``) both sweeps have bf16
kernels (``sa_bwd2_sweep1_bf16``, ``sa_bwd2_sweep2_bf16``, entry points
``facl_sa_*_bf16``) that read x, p1, p2 and dpooled and store q3 in bf16,
with every product on bf16 operands summed in f32 on the bf16 tensor
cores; their twins define the cast points (below). B8b's bf16 kernel
(also B6's, ops/sa_pair.py) runs one 512-thread block an SM over 128-row
steps and takes 16-byte aligned p1, p2 and q3 (16-byte copies); its f32
accumulators are added to the float64 partials every 32 steps, so only
the order of the sums differs from the twin's. hybrid's forward is then
the bf16 reference (ops/fused_sa.py), whose p1 and p2 are stored in bf16
as JAX's _forward_ps stores them. The host algebra stays f32.

Input cotangent contract: ZERO (sa_bwd.py:37-39) — the grouped
neighbourhoods are data in the training step; ``sa_impl="analytic"``
(ops/analytic_sa.py) returns the input gradient.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from facl_tpu_torch.ops._launch import I, L, P, TRUNK, check_c0, \
    check_pool, entry, grid, launch, need, need_aligned, on_cpu, ptr, \
    reduce, stream_of
from facl_tpu_torch.ops.fused_sa import BF16, SALayerParams, \
    sa_reference_4d


def _fold_affine(lp: SALayerParams, mean, var, eps):
    """y = p*mul + shift (per channel) for one layer."""
    mul = torch.rsqrt(var + eps) * lp.scale
    shift = lp.shift - mean * mul
    return mul, shift


def _h_from_p(p, mul, shift, dtype=torch.float32):
    """h = relu(p*mul + shift) from a stored pre-activation — the op chain
    the kernels use (ops/csrc/sa_tile.cuh::relu_affine). At bf16 the affine
    runs in f32 on p's upcast and is rounded to bf16 before the ReLU
    (facl_tpu/ops/pallas/sa_bwd.py:63-67); the result is bf16."""
    if dtype != torch.bfloat16:
        return torch.relu(p * mul + shift)
    return torch.relu((p.float() * mul + shift).to(dtype))


def _layer_terms(A, u, lp: SALayerParams, mean, var, G, ch, n: int,
                 eps: float) -> Dict[str, torch.Tensor]:
    """Closed-form per-layer gradients and propagation matrices from the
    dy-dependent globals (A = dy^T h_prev (Cout, Cin), u = sum dy) and the
    h-only reductions (G = Gram(h_prev), ch = colsum(h_prev))."""
    W, b, gamma = lp.kernel, lp.bias, lp.scale
    inv = torch.rsqrt(var + eps)
    gi = gamma * inv
    v = inv * ((A * W.T).sum(1) + u * (b - mean))
    HX = (G @ W + ch[:, None] * (b - mean)[None, :]) * inv[None, :]
    dW = gi[None, :] * (A.T - ch[:, None] * (u / n)[None, :]
                        - HX * (v / n)[None, :])
    sum_xhat = (ch @ W + n * b - n * mean) * inv
    db = -gi * sum_xhat * v / n
    s = gi * v / n
    M = (W * (inv * s)[None, :]) @ W.T
    rc = (gi * u / n + (b - mean) * inv * s) @ W.T
    return dict(v=v, dW=dW, db=db, dgamma=v, dbeta=u, M=M, rc=rc, gi=gi)


def _layer1_terms(m: Dict[str, torch.Tensor], t2, lp1: SALayerParams,
                  mean1, var1, n: int, eps: float):
    """Layer 1 in closed form from the sweep-2 moments ``m``
    (sa_bwd.py:333-339): dy1 = m1 (q2 - h1 M2 - rc2) contracted through
    acc1, TM1, cnt1 (u1) and P1, U1, T1x (A1 = dy1^T x)."""
    M2, rc2 = t2["M"], t2["rc"]
    u1 = m["acc1"] - torch.einsum("cj,jc->c", m["TM1"], M2) \
        - m["cnt1"] * rc2
    A1 = (m["P1"] - torch.einsum("jc,cji->ci", M2, m["U1"])
          - rc2[:, None] * m["T1x"])
    return _layer_terms(A1, u1, lp1, mean1, var1, m["Gx"], m["cx"], n, eps)


# -- plain twins --------------------------------------------------------

def _dy_top(z, dpooled, pool: int):
    """dy3 (R, C3) from z (R, C3), the layer-3 BatchNorm output before its
    ReLU: each group's dpooled split evenly among the rows whose relu(z)
    equals the group's max, where z > 0 (sa_bwd.py:70-91)."""
    C = z.shape[1]
    zg = z.reshape(-1, pool, C)
    h3 = torch.relu(zg)
    eq = h3 == h3.amax(1, keepdim=True)
    ties = eq.sum(1, keepdim=True).to(z.dtype)
    return torch.where(eq & (zg > 0), dpooled[:, None, :] / ties,
                       0.0).reshape(-1, C)


def sa_bwd2_sweep1_plain(p2, mul2, shift2, w3, b3, mul3, shift3, gi3,
                         dpooled, pool: int):
    """-> (A3 = dy3^T h2 (C3, C2), u3 = sum dy3, Gram(h2), colsum(h2),
    q3 = (gi3 dy3) W3^T (R, C2))."""
    h2 = _h_from_p(p2, mul2, shift2)
    dy3 = _dy_top((h2 @ w3 + b3) * mul3 + shift3, dpooled, pool)
    return dy3.T @ h2, dy3.sum(0), h2.T @ h2, h2.sum(0), (dy3 * gi3) @ w3.T


def _sweep2_sums(x, h1, dy2, q2):
    """The accumulators of B6 / B8b from rows x (R, C0), h1 (R, C1), dy2
    and q2 = (gi2 dy2) W2^T: A2 = dy2^T h1, u2, G1 = Gram(h1), ch1, and
    with m1 = [h1 > 0] and mq = m1 q2: cnt1 = sum m1, acc1 = sum mq, T1x =
    m1^T x, P1 = mq^T x, Gx = Gram(x), cx, TM1 = m1^T h1, U1[c, j, i] =
    sum m1_c x_i h1_j."""
    m1 = (h1 > 0).to(h1.dtype)
    mq = torch.where(h1 > 0, q2, 0.0)
    U1 = torch.stack([(m1 * x[:, i:i + 1]).T @ h1
                      for i in range(x.shape[1])], -1)
    return dict(A2=dy2.T @ h1, u2=dy2.sum(0), G1=h1.T @ h1, ch1=h1.sum(0),
                cnt1=m1.sum(0), acc1=mq.sum(0), T1x=m1.T @ x, P1=mq.T @ x,
                Gx=x.T @ x, cx=x.sum(0), TM1=m1.T @ h1, U1=U1)


def _sweep2_plain(x, h1, p2, mul2, shift2, q3, M3, rc3, gi2, w2):
    """B6 / B8b's accumulators (``_sweep2_sums``) with dy2 = [h2 > 0] (q3
    - h2 M3 - rc3)."""
    h2 = _h_from_p(p2, mul2, shift2)
    dy2 = torch.where(h2 > 0, q3 - h2 @ M3 - rc3, 0.0)
    return _sweep2_sums(x, h1, dy2, (dy2 * gi2) @ w2.T)


def sa_bwd2_sweep2_plain(x, p1, mul1, shift1, p2, mul2, shift2, q3, M3, rc3,
                         gi2, w2):
    return _sweep2_plain(x, _h_from_p(p1, mul1, shift1), p2, mul2, shift2,
                         q3, M3, rc3, gi2, w2)


# -- bf16 twins ----------------------------------------------------------
# B8a and B8b at compute_dtype bfloat16, as the TPU kernels trace them
# (facl_tpu/ops/pallas/sa_bwd.py:63-190 at dtype=bfloat16), with the rule
# of ops/sa_pair.py's bf16 twins: f32 arithmetic on bf16-rounded values,
# one explicit rounding (``_rb``) per cast point of the TPU kernel, and a
# bf16 + bf16 sum that nothing casts or stores kept in f32 (p3). x, p1,
# p2, q3 and dpooled are stored in bf16; every product takes bf16 operands
# (the f32 parameters rounded) and sums in f32. The accumulators ride the
# TPU kernels' packed products, whose left operands are the bf16 rows: u3,
# u2 and acc1 are sums of bf16-rounded dy3, dy2 and mq (sa_bwd.py:118-123,
# :178-186). B6 (ops/sa_pair.py) shares ``_sweep2_bf16``.

def _rb(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16, carried in f32: one cast point."""
    return t.to(BF16).float()


def _same(t: torch.Tensor) -> torch.Tensor:
    """No rounding: the f32 form of a cast point (``_rb``'s stand-in)."""
    return t


def _h_bf16(p, mul, shift):
    """relu(bf16(p mul + shift)) from a stored bf16 pre-activation, as f32
    (sa_bwd.py:63-67)."""
    return _h_from_p(p, mul, shift, BF16).float()


def _z_bf16(h2, w3, b3, mul3, shift3):
    """The layer-3 BatchNorm output before its ReLU, in f32: p3 = bf16(h2
    W3) + bf16(b3) summed in f32, then p3 mul3 + shift3 (sa_bwd.py:
    76-78, sa_fwd.py:127-130)."""
    return (_rb(h2 @ _rb(w3)) + _rb(b3)) * mul3 + shift3


def sa_bwd2_sweep1_bf16_plain(p2, mul2, shift2, w3, b3, mul3, shift3, gi3,
                              dpooled, pool: int):
    """-> (A3 = dy3^T h2, u3 = sum dy3, Gram(h2), colsum(h2) in f32, q3
    (R, C2) bf16) with dy3 the bf16 rounding of the f32 tie split of the
    bf16 cotangent dpooled, decided on the f32 z, and q3 = bf16(bf16(dy3
    bf16(gi3)) bf16(W3)^T) (sa_bwd.py:101-135)."""
    h2 = _h_bf16(p2, mul2, shift2)
    dy3 = _rb(_dy_top(_z_bf16(h2, w3, b3, mul3, shift3), dpooled.float(),
                      pool))
    q3 = _rb(_rb(dy3 * _rb(gi3)) @ _rb(w3).T)
    return dy3.T @ h2, dy3.sum(0), h2.T @ h2, h2.sum(0), q3.to(BF16)


def _sweep2_bf16(x, h1, p2, mul2, shift2, q3, M3, rc3, gi2, w2):
    """B6 / B8b's accumulators at bf16 from x and h1 (f32 holding bf16
    values): dy2 = bf16([h2 > 0] (q3 - bf16(h2 bf16(M3)) - rc3)), q2 =
    bf16(bf16(dy2 bf16(gi2)) bf16(W2)^T) (sa_bwd.py:150-170)."""
    h2 = _h_bf16(p2, mul2, shift2)
    dy2 = _rb(torch.where(h2 > 0, q3.float() - _rb(h2 @ _rb(M3)) - rc3,
                          0.0))
    return _sweep2_sums(x, h1, dy2, _rb(_rb(dy2 * _rb(gi2)) @ _rb(w2).T))


def sa_bwd2_sweep2_bf16_plain(x, p1, mul1, shift1, p2, mul2, shift2, q3,
                              M3, rc3, gi2, w2):
    """B8b at bf16: x, p1, p2, q3 bf16 -> the accumulators in f32."""
    return _sweep2_bf16(x.float(), _h_bf16(p1, mul1, shift1), p2, mul2,
                        shift2, q3, M3, rc3, gi2, w2)


# -- kernel wrappers ----------------------------------------------------
# Each sweep has an f32 and a bf16 instantiation of one CUDA template
# (csrc/sa_2sweep.cu; entry points facl_sa_*, facl_sa_*_bf16), each with its
# own wrapper, twin and launch counter. ``dt`` is the storage dtype of the
# rows (x, p1, p2, q3, dpooled); a row tensor stored otherwise raises.

def _sweep1(p2, mul2, shift2, w3, b3, mul3, shift3, gi3, dpooled, pool, dt):
    R = p2.shape[0]
    C2, C3 = TRUNK[1], TRUNK[2]
    check_pool(R, pool)
    need(p2, (R, C2), "p2", dt)
    need(w3, (C2, C3), "w3")
    need(dpooled, (R // pool, C3), "dpooled", dt)
    need_aligned(p2, "p2")
    vec = torch.cat([mul2, shift2, b3, mul3, shift3, gi3]).contiguous()
    need(vec, (2 * C2 + 4 * C3,), "mul2|shift2|b3|mul3|shift3|gi3")
    nblk = grid(p2, R, per_sm=1)      # one 512-thread block an SM
    dev = p2.device
    q3 = torch.empty((R, C2), dtype=dt, device=dev)
    partA = torch.empty((nblk, C3, C2), dtype=torch.float64, device=dev)
    partu = torch.empty((nblk, C3), dtype=torch.float64, device=dev)
    partG = torch.empty((nblk, C2, C2), dtype=torch.float64, device=dev)
    partc = torch.empty((nblk, C2), dtype=torch.float64, device=dev)
    launch("sa_2sweep", entry("bwd2_sweep1", dt),
           [P, L, I, P, P, P, P, P, P, P, P, I, P],
           ptr(p2), R, pool, ptr(vec), ptr(w3), ptr(dpooled), ptr(q3),
           ptr(partA), ptr(partu), ptr(partG), ptr(partc), nblk,
           stream_of(p2), what=entry("bwd2_sweep1", dt))
    return reduce(partA), reduce(partu), reduce(partG), reduce(partc), q3


def sa_bwd2_sweep1(p2, mul2, shift2, w3, b3, mul3, shift3, gi3, dpooled,
                   pool: int):
    """B8a. -> (A3 (C3, C2), u3 (C3,), G2 (C2, C2), ch2 (C2,), q3 (R, C2))."""
    if on_cpu(p2):
        return sa_bwd2_sweep1_plain(p2, mul2, shift2, w3, b3, mul3, shift3,
                                    gi3, dpooled, pool)
    out = _sweep1(p2, mul2, shift2, w3, b3, mul3, shift3, gi3, dpooled, pool,
                  torch.float32)
    sa_bwd2_sweep1.launches += 1
    return out


def sa_bwd2_sweep1_bf16(p2, mul2, shift2, w3, b3, mul3, shift3, gi3,
                        dpooled, pool: int):
    """B8a at bf16: p2, dpooled bf16 -> (A3, u3, G2, ch2 in f32, q3 bf16)."""
    if on_cpu(p2):
        return sa_bwd2_sweep1_bf16_plain(p2, mul2, shift2, w3, b3, mul3,
                                         shift3, gi3, dpooled, pool)
    out = _sweep1(p2, mul2, shift2, w3, b3, mul3, shift3, gi3, dpooled, pool,
                  BF16)
    sa_bwd2_sweep1_bf16.launches += 1
    return out


def _launch_sweep2(x, B: int, C0: int, N: int, p1, w1, b1, mul1, shift1,
                   p2, mul2, shift2, q3, M3, rc3, gi2, w2, dt
                   ) -> Dict[str, torch.Tensor]:
    """Launch csrc/sa_2sweep.cu's sweep 2 (B6 with p1=None, h1 from x;
    B8b with the stored p1) on rows stored as ``dt`` and unpack its
    accumulators: at f32 bwd2_sweep2_tf32_kernel (rows at any 4-byte
    alignment), at bf16 bwd2_sweep2_bf16_kernel (p1, p2 and q3 16-byte
    aligned), each one 512-thread block an SM."""
    R = B * N
    C1, C2 = TRUNK[0], TRUNK[1]
    need(p2, (R, C2), "p2", dt)
    need(q3, (R, C2), "q3", dt)
    need(M3, (C2, C2), "M3")
    need(w2, (C1, C2), "w2")
    if p1 is None:
        need(w1, (C0, C1), "w1")
    else:
        need(p1, (R, C1), "p1", dt)
    vec = torch.cat([b1, mul1, shift1, mul2, shift2, rc3, gi2]).contiguous()
    need(vec, (7 * C1,), "vectors")
    if dt == BF16:          # one 512-thread block an SM, 16-byte copies
        for t, name in ((p2, "p2"), (q3, "q3"), (p1, "p1")):
            if t is not None:
                need_aligned(t, name)
    nblk = grid(x, R, per_sm=1)       # one 512-thread block an SM
    dev = x.device
    nx = 2 * C1 * C0 + C0 * (C0 + 1)
    partM = torch.empty((nblk, 2, C2, C1), dtype=torch.float64, device=dev)
    partV = torch.empty((nblk, 4, C1), dtype=torch.float64, device=dev)
    partX = torch.empty((nblk, nx), dtype=torch.float64, device=dev)
    partU = torch.empty((nblk, C0 + 1, C1, C1), dtype=torch.float64,
                        device=dev)
    name = entry("bwd2_sweep2", dt)
    launch("sa_2sweep", name,
           [P, I, I, I, P, P, P, P, P, P, P, P, P, P, P, I, P],
           ptr(x), B, C0, N, None if p1 is None else ptr(p1),
           None if p1 is not None else ptr(w1), ptr(vec), ptr(p2), ptr(q3),
           ptr(M3), ptr(w2), ptr(partM), ptr(partV), ptr(partX),
           ptr(partU), nblk, stream_of(x),
           what=name if p1 is not None else name + " (B6)")
    M, V, X, U = (reduce(t) for t in (partM, partV, partX, partU))
    n1 = C1 * C0
    gx = X[2 * n1:].view(C0, C0 + 1)
    return dict(A2=M[0], u2=V[0], G1=M[1], ch1=V[1], cnt1=V[2], acc1=V[3],
                T1x=X[:n1].view(C1, C0), P1=X[n1:2 * n1].view(C1, C0),
                Gx=gx[:, :C0], cx=gx[:, C0], TM1=U[0],
                U1=U[1:].permute(1, 2, 0))


def _sweep2(x, p1, mul1, shift1, p2, mul2, shift2, q3, M3, rc3, gi2, w2, dt):
    R, C0 = x.shape
    need(x, (R, C0), "x", dt)
    check_c0(C0, R)
    return _launch_sweep2(x, R, C0, 1, p1, None, torch.zeros_like(mul1),
                          mul1, shift1, p2, mul2, shift2, q3, M3, rc3, gi2,
                          w2, dt)


def sa_bwd2_sweep2(x, p1, mul1, shift1, p2, mul2, shift2, q3, M3, rc3, gi2,
                   w2) -> Dict[str, torch.Tensor]:
    """B8b. x (R, C0) rows, p1/p2 (R, 64) the stored pre-activations.
    -> the accumulators of ``_sweep2_sums`` by name."""
    if on_cpu(x):
        return sa_bwd2_sweep2_plain(x, p1, mul1, shift1, p2, mul2, shift2,
                                    q3, M3, rc3, gi2, w2)
    out = _sweep2(x, p1, mul1, shift1, p2, mul2, shift2, q3, M3, rc3, gi2,
                  w2, torch.float32)
    sa_bwd2_sweep2.launches += 1
    return out


def sa_bwd2_sweep2_bf16(x, p1, mul1, shift1, p2, mul2, shift2, q3, M3, rc3,
                        gi2, w2) -> Dict[str, torch.Tensor]:
    """B8b at bf16: x, p1, p2, q3 bf16 -> the accumulators in f32 (the
    tensor-core kernel; p1, p2, q3 16-byte aligned or ValueError)."""
    if on_cpu(x):
        return sa_bwd2_sweep2_bf16_plain(x, p1, mul1, shift1, p2, mul2,
                                         shift2, q3, M3, rc3, gi2, w2)
    out = _sweep2(x, p1, mul1, shift1, p2, mul2, shift2, q3, M3, rc3, gi2,
                  w2, BF16)
    sa_bwd2_sweep2_bf16.launches += 1
    return out


KERNELS = (sa_bwd2_sweep1, sa_bwd2_sweep2, sa_bwd2_sweep1_bf16,
           sa_bwd2_sweep2_bf16)
for _k in KERNELS:
    _k.launches = 0


def _sweeps(dtype):
    """B8's two sweeps at ``dtype``: the bf16 ones, or the f32 ones for any
    other dtype (the module's names, read at call time)."""
    if dtype == BF16:
        return sa_bwd2_sweep1_bf16, sa_bwd2_sweep2_bf16
    return sa_bwd2_sweep1, sa_bwd2_sweep2


# -- the stage ----------------------------------------------------------

def sa_backward_2sweep(x, p1, p2, layers: Sequence[SALayerParams], stats,
                       dpooled, pool: int, eps: float, dtype=torch.float32):
    """The two-sweep backward (sa_bwd.py:232-348). x (R, C0) input rows,
    p1/p2 (R, 64) stored pre-activations, dpooled (R // pool, C3), all
    stored in ``dtype`` (bf16 runs the bf16 sweeps; any other dtype the
    f32 form). Returns ((dW, db, dgamma, dbeta) per layer) in f32."""
    sweep1, sweep2 = _sweeps(dtype)
    lp1, lp2, lp3 = layers
    (mean1, var1), (mean2, var2), (mean3, var3) = stats
    n = x.shape[0]
    mul1, shift1 = _fold_affine(lp1, mean1, var1, eps)
    mul2, shift2 = _fold_affine(lp2, mean2, var2, eps)
    mul3, shift3 = _fold_affine(lp3, mean3, var3, eps)
    gi2 = lp2.scale * torch.rsqrt(var2 + eps)
    gi3 = lp3.scale * torch.rsqrt(var3 + eps)

    A3, u3, G2, ch2, q3 = sweep1(p2, mul2, shift2, lp3.kernel, lp3.bias,
                                 mul3, shift3, gi3, dpooled, pool)
    t3 = _layer_terms(A3, u3, lp3, mean3, var3, G2, ch2, n, eps)
    m = sweep2(x, p1, mul1, shift1, p2, mul2, shift2, q3,
               t3["M"].contiguous(), t3["rc"], gi2, lp2.kernel)
    t2 = _layer_terms(m["A2"], m["u2"], lp2, mean2, var2, m["G1"],
                      m["ch1"], n, eps)
    t1 = _layer1_terms(m, t2, lp1, mean1, var1, n, eps)
    return [(t["dW"], t["db"], t["dgamma"], t["dbeta"]) for t in (t1, t2, t3)]


class _TwoSweep(torch.autograd.Function):
    """pooled, *stats = f(x, eps, forward, dtype, *12 layer tensors) for x
    (..., K, C0) stored in ``dtype``, where ``forward(rows, layers, K, eps,
    dtype)`` returns (pooled rows, stats, p1, p2); the backward is
    :func:`sa_backward_2sweep` on the stored p1/p2. Stats carry no gradient
    (they feed the running-statistics update); the input cotangent is zero
    by contract."""

    @staticmethod
    def forward(ctx, x, eps, forward, dtype, *flat):
        layers = [SALayerParams(*flat[4 * i:4 * i + 4]) for i in range(3)]
        K, C0 = x.shape[-2:]
        rows = x.reshape(-1, C0).contiguous()
        pooled, stats, p1, p2 = forward(rows, layers, K, eps, dtype)
        flat_stats = [m for s in stats for m in s]
        ctx.eps, ctx.pool, ctx.x_shape, ctx.dtype = eps, K, x.shape, dtype
        ctx.save_for_backward(rows, p1, p2, *flat, *flat_stats)
        ctx.mark_non_differentiable(*flat_stats)
        return (pooled.reshape(*x.shape[:-2], -1), *flat_stats)

    @staticmethod
    def backward(ctx, dpooled, *_):
        rows, p1, p2, *rest = ctx.saved_tensors
        layers = [SALayerParams(*rest[4 * i:4 * i + 4]) for i in range(3)]
        st = rest[12:]
        stats = [(st[0], st[1]), (st[2], st[3]), (st[4], st[5])]
        grads = sa_backward_2sweep(
            rows, p1, p2, layers, stats,
            dpooled.reshape(-1, dpooled.shape[-1]).contiguous(), ctx.pool,
            ctx.eps, ctx.dtype)
        return (torch.zeros(ctx.x_shape, dtype=rows.dtype,
                            device=rows.device), None, None, None,
                *(g for layer in grads for g in layer))


def two_sweep_train(forward, x: torch.Tensor,
                    layers: Sequence[SALayerParams], eps: float, name: str,
                    dtype=torch.float32) -> Tuple[torch.Tensor, list]:
    """The stage of ``forward`` + :func:`sa_backward_2sweep`; at ``dtype``
    bfloat16 on x cast to bf16 (sa_fwd.py:264, sa_bwd.py:391)."""
    if len(layers) != 3:
        raise ValueError(f"the {name} stage is specialised to 3 layers")
    if dtype == BF16:
        x = x.to(BF16)
    out = _TwoSweep.apply(x, eps, forward, dtype,
                          *(t for lp in layers for t in lp))
    st = out[1:]
    return out[0], [(st[0], st[1]), (st[2], st[3]), (st[4], st[5])]


def _forward_ps(rows, layers, pool: int, eps: float, dtype=torch.float32):
    """The reference op sequence on rows grouped ``pool`` at a time
    (sa_bwd.py:351-373): pooled, stats and the pre-activations p1, p2 as
    residuals, at bf16 stored in bf16 (the stage's bf16 form,
    ops/fused_sa.py). Plain torch, the matmuls too: the JAX package
    computes this forward in XLA, outside Pallas."""
    pooled, stats, ps, _ = sa_reference_4d(
        rows.view(-1, pool, rows.shape[1]), layers, eps, dtype=dtype)
    return (pooled, stats, ps[0].reshape(rows.shape[0], -1),
            ps[1].reshape(rows.shape[0], -1))


def sa_train_hybrid(x: torch.Tensor, layers: Sequence[SALayerParams],
                    eps: float = 1e-5, dtype=torch.float32
                    ) -> Tuple[torch.Tensor, list]:
    """``sa_impl="hybrid"``: the plain reference forward + the two-sweep
    backward (B8). x (..., K, C0), max-pooled over K;
    ``dtype=torch.bfloat16`` runs the bf16 forward and the bf16 sweeps on x
    cast to bf16, and the pooled output is then bf16. Returns (pooled
    (..., C3), [(mean, var)] x 3). Differentiable in every layer
    parameter; the input cotangent is ZERO."""
    return two_sweep_train(_forward_ps, x, layers, eps, "hybrid", dtype)
