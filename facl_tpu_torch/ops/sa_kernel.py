"""B9: the generic fused SA kernel of ``sa_impl="pallas"`` (counterpart of
facl_tpu/ops/pallas/sa_kernel.py).

[Dense -> BatchNorm(train) -> ReLU] x L, then the max over each group of
``pool`` consecutive rows, for L <= 4 layers of width <= 256 on C0 <= 8
input channels and pool <= 128. Nothing but the input, the pooled output
and per-channel vectors reaches device memory: every sweep recomputes the
activations it needs (csrc/sa_fused.cu). A grid-wide barrier on the TPU is
a launch boundary here, so

  forward   L stats sweeps (:func:`sa_fused_stats`, layer l's sums of p
            and p^2 with layers < l recomputed from their finalised
            statistics), then the pool sweep (:func:`sa_fused_pool`);
  backward  L BN-sum sweeps top-down (:func:`sa_fused_bnsum`, layer l's
            sums of dy and dy * xhat), then the final sweep
            (:func:`sa_fused_final`: dW, db of every layer and, with
            ``need_dx``, the input gradient).

The max-pool cotangent is split evenly among each group's exact ties
(sa_kernel.py:513-529). At float32 a kernel on the TF32 tensor cores (its
products in the 3xTF32 split) serves every net whose 64-row tile fits its
shared memory (pool <= 64; the main path's net does), the CUDA-core kernel
the rest (:func:`f32_on_tensor_cores`). Each sweep has a plain PyTorch
twin (``*_plain``,
the same op chain on whole tensors); a CPU tensor takes the twin, a CUDA
tensor launches the kernel or raises, and each wrapper counts its
launches. The kernel sums its per-block float64 partials in a fixed order
here, so every result is deterministic.

At ``compute_dtype=bfloat16`` (``*_bf16``: entry point
``facl_sa_fused_bf16``, a kernel of its own on the bf16 tensor cores for
every net whose tile fits its shared memory, the CUDA-core kernel's bf16
instantiation for the rest (:func:`bf16_on_tensor_cores`), and their own
twins and counters) the sweeps follow the cast points that the JAX kernel
at bf16 rounds, as its interpret-mode outputs show (not every cast its
source writes): x and the weights are rounded to bf16 at load; each
product h W sums exact bf16 products in f32 and is rounded to bf16 (as
the k-order sum rounds it, csrc/sa_fused.cu says how far), and the bf16
bias adds to it in f32, unrounded (XLA keeps that sum in f32); the
affines run in f32 and y is rounded to bf16 before the ReLU, so the
activations, the ReLU masks and the pooled values (f32 out) are bf16
values, and the pool ties are taken on them. Backward: dy, dp and the BN
sums in f32; da = bf16(dp) bf16(W)^T with f32 sums; dW = h^T dp, db and
dx = dp0 W0^T with the f32 dp and the f32 W0. The stage's forward and
backward build the kernels' flat weights (:func:`_prm`) once each and pass
them to every launch (``prm``); a sweep called alone builds them itself.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from facl_tpu_torch.ops import _build
from facl_tpu_torch.ops._launch import need, on_cpu, reduce
from facl_tpu_torch.ops.fused_sa import BF16, SALayerParams
from facl_tpu_torch.ops.sa_bwd import _rb, _same
from facl_tpu_torch.ops.sa_fwd import _finalize

LMAX, WMAX, C0MAX, POOLMAX = 4, 256, 8, 128
SMEM_MAX = 227 * 1024
NVEC = 8     # rows of the per-layer vectors (csrc/sa_fused.cu enum)

_P, _I = _build.P, _build.I
_LL = ctypes.c_longlong
_ARGS = [_I, _I, _P, _LL, _I, _I, _P, _I, _P, _P, _P, _P, _P, _I, _P]


def _widths(layers: Sequence[SALayerParams]) -> List[int]:
    return [int(lp.kernel.shape[1]) for lp in layers]


def vectors(layers: Sequence[SALayerParams], packed: torch.Tensor,
            bsums: Optional[torch.Tensor], R: int,
            bf: bool = False) -> torch.Tensor:
    """(L, 8, 256) per-channel vectors of every sweep, from the statistics
    ``packed`` (L, 2, cmax) [mean, inv] and the backward's BN sums
    ``bsums`` (L, 2, cmax) [sum dy, sum dy * xhat] (zeros if None): b,
    inv, bx = -mean inv, ay = inv gamma, by = beta - mean ay, gi = gamma
    inv, sum dy / R, sum dy xhat / R — the JAX kernel's folded affines
    (sa_kernel.py:54-80, :532-560). With ``bf`` the bias row is the
    bf16-rounded bias (sa_kernel.py:64)."""
    L = len(layers)
    v = torch.zeros(L, NVEC, WMAX, dtype=packed.dtype, device=packed.device)
    for l, lp in enumerate(layers):
        w = lp.kernel.shape[1]
        mean, inv = packed[l, 0, :w], packed[l, 1, :w]
        ay = inv * lp.scale
        v[l, 0, :w] = _rb(lp.bias) if bf else lp.bias
        v[l, 1, :w] = inv
        v[l, 2, :w] = -mean * inv
        v[l, 3, :w] = ay
        v[l, 4, :w] = lp.shift - mean * ay
        v[l, 5, :w] = lp.scale * inv
        if bsums is not None:
            v[l, 6, :w] = bsums[l, 0, :w] / R
            v[l, 7, :w] = bsums[l, 1, :w] / R
    return v


# -- plain twins --------------------------------------------------------

def _forward_plain(x, layers, v, upto: int, bf: bool = False):
    """Layers < upto on whole tensors with the kernel's op chain. Returns
    (pre-activations [p_l], layer inputs [x, h_0, .., h_{upto-1}]). With
    ``bf`` the bf16 cast points (module docstring) round, in f32."""
    r = _rb if bf else _same
    ps, hs = [], [r(x)]
    for l in range(upto):
        w = layers[l].kernel.shape[1]
        p = r(hs[-1] @ r(layers[l].kernel)) + v[l, 0, :w]
        ps.append(p)
        hs.append(torch.relu(r(p * v[l, 3, :w] + v[l, 4, :w])))
    return ps, hs


def _pool_grad(h, dout, pool: int):
    """Even split of each group's cotangent among its exact ties
    (sa_kernel.py:513-529)."""
    C = h.shape[1]
    hg = h.reshape(-1, pool, C)
    ties = (hg == hg.amax(1, keepdim=True)).to(h.dtype)
    cnt = ties.sum(1, keepdim=True)
    return (ties * dout[:, None, :] / cnt).reshape(-1, C)


def _backward_plain(x, layers, v, dout, pool: int, target: int,
                    need_dx: bool, bf: bool = False):
    """Propagate the pooled cotangent down to layer ``target`` (BN sums:
    returns (sum dy, sum dy xhat)), or with target -1 to the input
    (returns (dx or None, [dW], [db]))."""
    r = _rb if bf else _same
    L = len(layers)
    ps, hs = _forward_plain(x, layers, v, L, bf)
    da = _pool_grad(hs.pop(), dout, pool)
    dws, dbs = [None] * L, [None] * L
    for l in range(L - 1, -1, -1):
        w = layers[l].kernel.shape[1]
        p = ps.pop()           # freed as the walk goes down (memory)
        dy = torch.where(r(p * v[l, 3, :w] + v[l, 4, :w]) > 0, da, 0.0)
        xh = p * v[l, 1, :w] + v[l, 2, :w]
        if l == target:
            return dy.sum(0), (dy * xh).sum(0)
        dp = v[l, 5, :w] * ((dy - v[l, 6, :w]) - xh * v[l, 7, :w])
        dws[l], dbs[l] = hs[l].T @ dp, dp.sum(0)
        if l:
            da = r(dp) @ r(layers[l].kernel).T
        elif need_dx:
            da = dp @ layers[l].kernel.T
    return (da if need_dx else None), dws, dbs


def sa_fused_stats_plain(x, layers, packed, pool: int, target: int,
                         bf: bool = False):
    v = vectors(layers, packed, None, x.shape[0], bf)
    r = _rb if bf else _same
    ps, hs = _forward_plain(x, layers, v, target, bf)
    w = layers[target].kernel.shape[1]
    p = r(hs[-1] @ r(layers[target].kernel)) + v[target, 0, :w]
    return p.sum(0), (p * p).sum(0)


def sa_fused_pool_plain(x, layers, packed, pool: int, bf: bool = False):
    v = vectors(layers, packed, None, x.shape[0], bf)
    h = _forward_plain(x, layers, v, len(layers), bf)[1][-1]
    return h.reshape(-1, pool, h.shape[1]).amax(1)


def sa_fused_bnsum_plain(x, layers, packed, bsums, dout, pool: int,
                         target: int, bf: bool = False):
    v = vectors(layers, packed, bsums, x.shape[0], bf)
    return _backward_plain(x, layers, v, dout, pool, target, False, bf)


def sa_fused_final_plain(x, layers, packed, bsums, dout, pool: int,
                         need_dx: bool = True, bf: bool = False):
    v = vectors(layers, packed, bsums, x.shape[0], bf)
    return _backward_plain(x, layers, v, dout, pool, -1, need_dx, bf)


def sa_fused_stats_bf16_plain(x, layers, packed, pool: int, target: int):
    return sa_fused_stats_plain(x, layers, packed, pool, target, True)


def sa_fused_pool_bf16_plain(x, layers, packed, pool: int):
    return sa_fused_pool_plain(x, layers, packed, pool, True)


def sa_fused_bnsum_bf16_plain(x, layers, packed, bsums, dout, pool: int,
                              target: int):
    return sa_fused_bnsum_plain(x, layers, packed, bsums, dout, pool,
                                target, True)


def sa_fused_final_bf16_plain(x, layers, packed, bsums, dout, pool: int,
                              need_dx: bool = True):
    return sa_fused_final_plain(x, layers, packed, bsums, dout, pool,
                                need_dx, True)


# -- kernel wrappers ----------------------------------------------------

def _widths_arg(widths: List[int]):
    return (ctypes.c_int * LMAX)(*(widths + [0] * (LMAX - len(widths))))


def _check(x, layers, pool: int, bf: bool) -> List[int]:
    """The kernel's range; raises ValueError outside it."""
    R, C0 = x.shape
    need(x, (R, C0), "x")
    widths = _widths(layers)
    L = len(widths)
    if not (1 <= L <= LMAX and 1 <= C0 <= C0MAX and 1 <= pool <= POOLMAX
            and R % pool == 0 and all(1 <= w <= WMAX for w in widths)):
        raise ValueError(
            f"the B9 kernel takes 1 <= L <= {LMAX} layers of width <= "
            f"{WMAX}, C0 <= {C0MAX} input channels and pool <= {POOLMAX} "
            f"dividing the rows; got L={L}, widths={widths}, C0={C0}, "
            f"pool={pool}, rows={R}")
    cin = C0
    for lp, w in zip(layers, widths):
        need(lp.kernel, (cin, w), "kernel")
        cin = w
    lib = _build.REGISTRY.get("sa_fused")
    fn = lib.facl_sa_fused_bf16_smem if bf else lib.facl_sa_fused_smem
    fn.argtypes = [_LL, _I, _I, _P, _I]
    fn.restype = _LL
    smem = fn(R, C0, L, ctypes.cast(_widths_arg(widths), _P), pool)
    if not 0 < smem <= SMEM_MAX:
        raise ValueError(
            f"B9: a tile of widths {widths} at pool={pool} needs {smem} "
            f"bytes of shared memory, more than the {SMEM_MAX} a block has "
            "(the layers below the top are kept per tile)")
    return widths


def _prm(layers, bf: bool) -> torch.Tensor:
    """W_0, W_0^T, W_1, W_1^T, ..., flat; with ``bf`` all rounded to bf16
    but W_0^T, the operand of dx = dp0 W0^T (f32 in the JAX kernel). Built
    once per forward or backward of the stage (its sweeps pass it on)."""
    r = _rb if bf else _same
    return torch.cat([t.reshape(-1) for l, lp in enumerate(layers)
                      for t in (r(lp.kernel), (r(lp.kernel.T) if l else
                                               lp.kernel.T).contiguous())]) \
        .contiguous()


def _on_tensor_cores(entry: str, R: int, C0: int, widths: List[int],
                     pool: int) -> bool:
    lib = _build.REGISTRY.get("sa_fused")
    fn = getattr(lib, entry)
    fn.argtypes = [_LL, _I, _I, _P, _I]
    fn.restype = _I
    return fn(R, C0, len(widths), ctypes.cast(_widths_arg(widths), _P),
              pool) == 1


def bf16_on_tensor_cores(R: int, C0: int, widths: List[int],
                         pool: int) -> bool:
    """Whether B9's bf16 sweeps of this net run on the tensor cores (the
    kernel's layout fits shared memory; the main path's net does) or on
    CUDA cores (the other nets of the range): csrc/sa_fused.cu."""
    return _on_tensor_cores("facl_sa_fused_bf16_tc", R, C0, widths, pool)


def f32_on_tensor_cores(R: int, C0: int, widths: List[int],
                        pool: int) -> bool:
    """Whether B9's f32 sweeps of this net run on the TF32 tensor cores
    (pool <= 64 and the kernel's 64-row layout fits shared memory; the
    main path's net does) or on CUDA cores (the other nets of the range):
    csrc/sa_fused.cu."""
    return _on_tensor_cores("facl_sa_fused_tc", R, C0, widths, pool)


def _nblk(x, widths: List[int], pool: int, bf: bool) -> int:
    """Persistent blocks: one an SM for a tensor-core kernel (512 threads
    and most of the shared memory), else two, no more than the tiles."""
    R, C0 = x.shape
    tiles = -(-(R // pool) // ((64 if pool <= 64 else 128) // pool))
    tc = bf16_on_tensor_cores if bf else f32_on_tensor_cores
    per_sm = 1 if tc(R, C0, widths, pool) else 2
    return max(1, min(tiles, per_sm * _build.sm_count(x.device)))


def _launch(mode, target, x, layers, widths, v, pool, dout, out, part,
            nblk, what, bf, prm):
    R, C0 = x.shape
    wa = _widths_arg(widths)
    handle, fn = _build.function(
        "sa_fused", "facl_sa_fused_bf16" if bf else "facl_sa_fused", _ARGS)
    code = fn(mode, target, _build.ptr(x), R, C0, len(widths),
              ctypes.cast(wa, _P), pool,
              _build.ptr(_prm(layers, bf) if prm is None else prm),
              _build.ptr(v), None if dout is None else _build.ptr(dout),
              None if out is None else _build.ptr(out), _build.ptr(part),
              nblk, _build.stream_of(x))
    _build.check(handle, code, what)


def _stats(x, layers, packed, pool, target, bf, what, prm):
    widths = _check(x, layers, pool, bf)
    v = vectors(layers, packed, None, x.shape[0], bf)
    nblk = _nblk(x, widths, pool, bf)
    part = torch.empty((nblk, 2, widths[target]), dtype=torch.float64,
                       device=x.device)
    _launch(0, target, x, layers, widths, v, pool, None, None, part, nblk,
            what, bf, prm)
    s = reduce(part)
    return s[0], s[1]


def _pool(x, layers, packed, pool, bf, what, prm):
    widths = _check(x, layers, pool, bf)
    R = x.shape[0]
    v = vectors(layers, packed, None, R, bf)
    nblk = _nblk(x, widths, pool, bf)
    pooled = torch.empty((R // pool, widths[-1]), dtype=torch.float32,
                         device=x.device)
    part = torch.empty(1, dtype=torch.float64, device=x.device)
    _launch(1, 0, x, layers, widths, v, pool, None, pooled, part, nblk, what,
            bf, prm)
    return pooled


def _bnsum(x, layers, packed, bsums, dout, pool, target, bf, what, prm):
    widths = _check(x, layers, pool, bf)
    need(dout, (x.shape[0] // pool, widths[-1]), "dout")
    v = vectors(layers, packed, bsums, x.shape[0], bf)
    nblk = _nblk(x, widths, pool, bf)
    part = torch.empty((nblk, 2, widths[target]), dtype=torch.float64,
                       device=x.device)
    _launch(2, target, x, layers, widths, v, pool, dout, None, part, nblk,
            what, bf, prm)
    s = reduce(part)
    return s[0], s[1]


def _final(x, layers, packed, bsums, dout, pool, need_dx, bf, what, prm):
    widths = _check(x, layers, pool, bf)
    R, C0 = x.shape
    need(dout, (R // pool, widths[-1]), "dout")
    v = vectors(layers, packed, bsums, R, bf)
    nblk = _nblk(x, widths, pool, bf)
    cins = [C0] + widths[:-1]
    ndw = sum(c * w for c, w in zip(cins, widths))
    part = torch.zeros((nblk, ndw + sum(widths)), dtype=torch.float64,
                       device=x.device)
    dx = torch.empty((R, C0), dtype=torch.float32, device=x.device) \
        if need_dx else None
    _launch(3, 0, x, layers, widths, v, pool, dout, dx, part, nblk, what, bf,
            prm)
    s = reduce(part)
    dws, dbs, o, ob = [], [], 0, ndw
    for c, w in zip(cins, widths):
        dws.append(s[o:o + c * w].view(c, w))
        dbs.append(s[ob:ob + w])
        o, ob = o + c * w, ob + w
    return dx, dws, dbs


# ``prm``: the flat weights (_prm) if the caller has built them, else None.

def sa_fused_stats(x, layers, packed, pool: int, target: int, prm=None):
    """Stats sweep of layer ``target`` -> (sum p, sum p^2), float32 (w,)."""
    if on_cpu(x, "B9"):
        return sa_fused_stats_plain(x, layers, packed, pool, target)
    out = _stats(x, layers, packed, pool, target, False, "sa_fused_stats",
                 prm)
    sa_fused_stats.launches += 1
    return out


def sa_fused_pool(x, layers, packed, pool: int, prm=None):
    """Pool sweep -> pooled (R // pool, w_top)."""
    if on_cpu(x, "B9"):
        return sa_fused_pool_plain(x, layers, packed, pool)
    pooled = _pool(x, layers, packed, pool, False, "sa_fused_pool", prm)
    sa_fused_pool.launches += 1
    return pooled


def sa_fused_bnsum(x, layers, packed, bsums, dout, pool: int, target: int,
                   prm=None):
    """BN-sum sweep of layer ``target`` -> (sum dy, sum dy xhat)."""
    if on_cpu(x, "B9"):
        return sa_fused_bnsum_plain(x, layers, packed, bsums, dout, pool,
                                    target)
    out = _bnsum(x, layers, packed, bsums, dout, pool, target, False,
                 "sa_fused_bnsum", prm)
    sa_fused_bnsum.launches += 1
    return out


def sa_fused_final(x, layers, packed, bsums, dout, pool: int,
                   need_dx: bool = True, prm=None):
    """Final sweep -> (dx (R, C0) or None, [dW_l], [db_l])."""
    if on_cpu(x, "B9"):
        return sa_fused_final_plain(x, layers, packed, bsums, dout, pool,
                                    need_dx)
    out = _final(x, layers, packed, bsums, dout, pool, need_dx, False,
                 "sa_fused_final", prm)
    sa_fused_final.launches += 1
    return out


def sa_fused_stats_bf16(x, layers, packed, pool: int, target: int,
                        prm=None):
    """The stats sweep at bf16: x (R, C0) float32, computed in bf16 ->
    (sum p, sum p^2), float32."""
    if on_cpu(x, "B9"):
        return sa_fused_stats_bf16_plain(x, layers, packed, pool, target)
    out = _stats(x, layers, packed, pool, target, True,
                 "sa_fused_stats_bf16", prm)
    sa_fused_stats_bf16.launches += 1
    return out


def sa_fused_pool_bf16(x, layers, packed, pool: int, prm=None):
    """The pool sweep at bf16 -> pooled (R // pool, w_top) float32 holding
    bf16 values (sa_kernel.py:271-274)."""
    if on_cpu(x, "B9"):
        return sa_fused_pool_bf16_plain(x, layers, packed, pool)
    pooled = _pool(x, layers, packed, pool, True, "sa_fused_pool_bf16", prm)
    sa_fused_pool_bf16.launches += 1
    return pooled


def sa_fused_bnsum_bf16(x, layers, packed, bsums, dout, pool: int,
                        target: int, prm=None):
    """The BN-sum sweep at bf16: ties of the bf16 top activations ->
    (sum dy, sum dy xhat), float32."""
    if on_cpu(x, "B9"):
        return sa_fused_bnsum_bf16_plain(x, layers, packed, bsums, dout,
                                         pool, target)
    out = _bnsum(x, layers, packed, bsums, dout, pool, target, True,
                 "sa_fused_bnsum_bf16", prm)
    sa_fused_bnsum_bf16.launches += 1
    return out


def sa_fused_final_bf16(x, layers, packed, bsums, dout, pool: int,
                        need_dx: bool = True, prm=None):
    """The final sweep at bf16 -> (dx (R, C0) or None, [dW_l], [db_l]),
    float32."""
    if on_cpu(x, "B9"):
        return sa_fused_final_bf16_plain(x, layers, packed, bsums, dout,
                                         pool, need_dx)
    out = _final(x, layers, packed, bsums, dout, pool, need_dx, True,
                 "sa_fused_final_bf16", prm)
    sa_fused_final_bf16.launches += 1
    return out


KERNELS = (sa_fused_stats, sa_fused_pool, sa_fused_bnsum, sa_fused_final,
           sa_fused_stats_bf16, sa_fused_pool_bf16, sa_fused_bnsum_bf16,
           sa_fused_final_bf16)
for _k in KERNELS:
    _k.launches = 0


def _sweeps(dtype):
    """B9's four sweeps at ``dtype``: the bf16 ones, or the f32 ones for
    any other."""
    if dtype == BF16:
        return (sa_fused_stats_bf16, sa_fused_pool_bf16,
                sa_fused_bnsum_bf16, sa_fused_final_bf16)
    return sa_fused_stats, sa_fused_pool, sa_fused_bnsum, sa_fused_final


# -- the forward and backward of the stage ------------------------------

def sa_train_forward_unified(x: torch.Tensor,
                             layers: Sequence[SALayerParams], pool: int,
                             eps: float = 1e-5,
                             dtype: torch.dtype = torch.float32):
    """x (R, C0) float32 -> (pooled (R // pool, C_L) float32, [(mean,
    var)] per layer, packed (L, 2, cmax) [mean, inv], zero past each
    width) (sa_kernel.py:247-297), computed in ``dtype`` (bf16 runs the
    bf16 sweeps; any other dtype the f32 ones)."""
    stats_sweep, pool_sweep, _, _ = _sweeps(dtype)
    prm = None if x.device.type == "cpu" else _prm(layers, dtype == BF16)
    R = x.shape[0]
    widths = _widths(layers)
    packed = torch.zeros(len(layers), 2, max(widths), dtype=x.dtype,
                         device=x.device)
    stats = []
    for l, w in enumerate(widths):
        s, ss = stats_sweep(x, layers, packed, pool, l, prm=prm)
        mean, var = _finalize(s, ss, R)
        packed[l, 0, :w] = mean
        packed[l, 1, :w] = torch.rsqrt(var + eps)
        stats.append((mean, var))
    return pool_sweep(x, layers, packed, pool, prm=prm), stats, packed


def sa_train_backward_unified(x: torch.Tensor,
                              layers: Sequence[SALayerParams],
                              packed: torch.Tensor, dout: torch.Tensor,
                              pool: int, need_dx: bool = True,
                              dtype: torch.dtype = torch.float32):
    """-> (dx (R, C0) or None, [(dW, db, dgamma, dbeta)] per layer)
    (sa_kernel.py:424-505): dgamma = sum dy xhat and dbeta = sum dy are
    the BN sums of the top-down sweeps; ``dtype`` as the forward's."""
    _, _, bnsum_sweep, final_sweep = _sweeps(dtype)
    prm = None if x.device.type == "cpu" else _prm(layers, dtype == BF16)
    widths = _widths(layers)
    bsums = torch.zeros_like(packed)
    for l in reversed(range(len(layers))):
        s_dy, s_dyx = bnsum_sweep(x, layers, packed, bsums, dout, pool, l,
                                  prm=prm)
        bsums[l, 0, :widths[l]] = s_dy
        bsums[l, 1, :widths[l]] = s_dyx
    dx, dws, dbs = final_sweep(x, layers, packed, bsums, dout, pool, need_dx,
                               prm=prm)
    return dx, [(dw, db, bsums[l, 1, :w], bsums[l, 0, :w])
                for l, (dw, db, w) in enumerate(zip(dws, dbs, widths))]
