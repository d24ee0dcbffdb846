#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of facl_tpu on one NVIDIA GPU and hold
every hand-written kernel against its plain PyTorch twin.

    python3 chip_smoke.py             # needs one CUDA device
    python3 chip_smoke.py --profile   # + a torch.profiler breakdown of
                                      #   one main-path step
    python3 chip_smoke.py --parent DIR  # + B2b, B3a, B3b and B3c of the
                                        #   tree in DIR (a git archive of
                                        #   another commit) timed against
                                        #   this tree's, in turns

Phases (any failure exits nonzero, before the final line):
  1. build   every kernel from facl_tpu_torch/ops/csrc (one nvcc per
             source, in parallel) and print the build time and ptxas use;
  2. kernels each kernel and its twin on the same card tensors at the
             main path's shapes (64 videos x 10 crops x 512 points, S=K=64,
             SA widths 4-64-64-256): B1, B4 and B5a bit-equal (B4's idx
             also to B1's); B5b within 1e-5 of the scale of index_add_,
             two runs equal;
             B2/B3/B6/B7/B8 accumulators to 1e-4 of their max-abs (cnt1
             exactly); B9's eight launches (stats to 1e-5, BN sums and dW
             to 1e-4 of their max-abs, db near zero); row outputs, pooled
             values and B9's dx at rtol 1e-5 / atol 1e-5 x scale; pool
             indices equal except where the twin's own values tie.
             B5a and B5b again on 0.8-cube clouds (spread rows).
             Times (device_ms): CUDA events around 20 back-to-back calls
             queued behind a spin of the card, so the device time excludes
             the host's; the host's time per call beside it; beside B5a
             and B5b one library call (torch.gather, index_add_). B2b, B3b
             and B3c (tensor cores, 3xTF32) print two bounds: the
             tensor-core one (bound_ms) and the f32 CUDA-core one
             (bound_f32_ms). B2b and B3a-B3c are run to run
             bit-identical, and are checked again on the fine variant's
             K = 128. Then
             the whole SA stage (forward + backward) of each sa_impl with
             kernels (pair3, pair, hybrid2, hybrid, pallas) at K=64 and
             K=128 on the same inputs as kernels, twins and float64
             twins: the kernels must be as close to float64 as the twins;
  3. cpu-vs-card one full-width train step at B=8 for pair3, pair, hybrid2
             and pallas on the CPU (twins) and on the card (kernels, then
             twins), same weights, points and permutation: loss at rtol
             1e-4, BN-absorbed biases near zero; the ReLU and pool
             decisions that flipped between the devices are counted,
             gradients held at max-abs 2e-4 of their scale where no flip
             reaches and at relative L2 1e-2 everywhere (phase_cpu_vs_card
             says why);
  4. main    the Trainer at full width, f32, B=64 (bench.py's workload),
             sa_impl pair3 (the default; the headline): 2 warm-up steps
             (run_epoch), then 40 steps timed by CUDA events between steps
             (median and spread); then pair, hybrid2, hybrid and pallas, 2
             warm-up and 20 timed steps each, and pallas on the split
             grouping routes (select_impl=pallas / gather_impl=xla: B4;
             xla / pallas: B5a), 2 + 5 steps each. Losses finite and every
             kernel of each path launched exactly its count per step
             (counters zeroed just before each path, read just after).
             --profile adds one profiled step to each impl's path: kernel
             time over that step's own span gives the device's idle share;
  5. input   d(loss)/d(points) through each grouping route and the
             pallas SA stage with input_grad (B9's dx, B5b) at B=8: card
             kernels vs card twins vs CPU (phase_input_grad), with exact
             launches per route.
Output: a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM (NVIDIA data sheet, dense, at the 700 W limit): f32 on CUDA
# cores, TF32 on tensor cores and HBM3 bandwidth.
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
SEED = 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_SPIN = {}


def _spin_cycles_per_ms() -> float:
    """Clock cycles of torch.cuda._sleep per ms on this card, measured."""
    if "rate" not in _SPIN:
        torch.cuda._sleep(1000)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        torch.cuda._sleep(10_000_000)
        e.record()
        e.synchronize()
        _SPIN["rate"] = 1e7 / s.elapsed_time(e)
    return _SPIN["rate"]


def device_ms(fn, n: int = 20):
    """(device ms per call, host us per call) of ``fn``. After two warm-up
    calls the card is set spinning (torch.cuda._sleep) ahead of the start
    event, for twice the time the host takes to queue n calls behind it;
    the start and end events then bracket n back-to-back calls that the
    device runs without waiting for the host. The host clock stamps each
    of the same n calls: the host time is the median call's. If the spin
    ended before the last call was queued (the start event had already
    passed), the run is repeated once with a spin sized from that median.
    A call that launches many kernels can fill the device's queue while
    the spin runs; the host then waits on the device (the device never
    idles), which the median skips while fewer than half the calls wait."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    for _ in range(2):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int((2e3 * n * host + 1.0) * _spin_cycles_per_ms()))
        s.record()
        stamps = [time.perf_counter()]
        for _ in range(n):
            fn()
            stamps.append(time.perf_counter())
        late = s.query()
        e.record()
        e.synchronize()
        host = statistics.median(b - a for a, b in zip(stamps, stamps[1:]))
        if not late:
            break
    return s.elapsed_time(e) / n, host * 1e6


def bound(nbytes: float, ops: float, tc_ops: float = 0.0):
    """(ms, "bytes" or "operations"): the larger of bytes over the memory
    rate and the operations over their peak rates — ``ops`` f32 on CUDA
    cores, ``tc_ops`` (f32-equivalent product flops) on tensor cores in
    3xTF32, three TF32 passes each."""
    tb = nbytes / PEAK_BYTES * 1e3
    to = (ops / PEAK_F32 + 3 * tc_ops / PEAK_TF32) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def acc_err(k, t, name):
    err = float((k - t).abs().max())
    scale = float(t.abs().max())
    check(err <= 1e-4 * max(scale, 1e-30),
          f"{name}: accumulator error {err:.3e} > 1e-4 x {scale:.3e}")
    return err


def row_err(k, t, name):
    scale = float(t.abs().max())
    diff = (k - t).abs()
    ok = bool((diff <= 1e-5 * t.abs() + 1e-5 * scale).all())
    check(ok, f"{name}: row error {float(diff.max()):.3e} "
              f"(scale {scale:.3e}) beyond rtol 1e-5 / atol 1e-5 x scale")
    return float(diff.max())


def index_err(k_idx, t_idx, t_vals, t_best, name):
    """Indices equal except where the twin's own values tie: at every
    mismatch the twin's value at the kernel's index equals its best."""
    bad = k_idx != t_idx
    if bool(bad.any()):
        g, c = bad.nonzero(as_tuple=True)
        v = t_vals[g, k_idx[g, c].long(), c]
        scale = float(t_vals.abs().max())
        tie = (v - t_best[g, c]).abs() <= 1e-5 * scale
        check(bool(tie.all()), f"{name}: {int((~tie).sum())} pool indices "
                               "differ where the twin has no tie")
    return int(bad.sum())


def sweep_modules():
    from facl_tpu_torch.ops import sa_bwd, sa_fwd, sa_pair
    return sa_pair, sa_fwd, sa_bwd


def sa_modules():
    """Every module with SA sweep kernels: sweep_modules() and B9's."""
    from facl_tpu_torch.ops import sa_kernel
    return sweep_modules() + (sa_kernel,)


@contextlib.contextmanager
def swapped(pairs):
    """Set each (module, name, value) for the block, then restore."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, v in pairs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def twins_on_card():
    """Route the SA stage's sweeps to their plain twins for card tensors
    (for the yardstick chains below; the port itself never does this)."""
    return swapped([(m, k.__name__, getattr(m, k.__name__ + "_plain"))
                    for m in sa_modules() for k in m.KERNELS])


def grouping_twins_on_card():
    """The same for the grouping kernels B1, B4, B5a and B5b."""
    from facl_tpu_torch.ops import gather as GA
    from facl_tpu_torch.ops import grouping as GR
    from facl_tpu_torch.ops import select as SEL

    def sg(points, S, K, r2, return_idx=False):
        return SEL.select_gather_plain(points, S, K, r2)
    return swapped([(SEL, "select_gather", sg),
                    (SEL, "select_knn_ball", SEL.select_knn_ball_plain),
                    (GR, "select_knn_ball", SEL.select_knn_ball_plain),
                    (GA, "gather_rows", GA.gather_rows_plain),
                    (GA, "scatter_add_rows", GA.scatter_add_rows_plain)])


def near_ties(z, pool: int, tol: float):
    """(P, C3) bool: the (group, channel) pairs whose two-sweep routing is
    a decision within ``tol`` of a switch — the group's largest z within
    tol of zero (the ReLU), or a distinct value of relu(z) within tol
    below a positive max. z: (R, C3), the layer-3 BN output before its
    ReLU. Exact ties (identical rows) are not near-ties: every evaluation
    splits them alike; nor are dead groups far below zero."""
    zg = z.reshape(-1, pool, z.shape[1])
    zmax = zg.amax(1, keepdim=True)
    gap = zmax - zg
    return (zmax[:, 0].abs() <= tol) | \
        ((zmax[:, 0] > 0) & ((gap > 0) & (gap <= tol)).any(1))


def b9_z(x, layers, packed):
    """z (R, C_L) of B9's top layer, its BatchNorm output before the ReLU,
    recomputed by the twins' op chain in x's dtype from the forward's
    packed statistics (for near_ties and the routing records)."""
    from facl_tpu_torch.ops import sa_kernel as SK
    layers = [SK.SALayerParams(*(t.to(x.dtype) for t in lp)) for lp in layers]
    v = SK.vectors(layers, packed.to(x.dtype), None, x.shape[0])
    h = SK._forward_plain(x, layers, v, len(layers) - 1)[1][-1]
    w = layers[-1].kernel.shape[1]
    return (h @ layers[-1].kernel + v[-1, 0, :w]) * v[-1, 3, :w] \
        + v[-1, 4, :w]


def _z64(p2, stats, lp2, lp3, eps=1e-5):
    """z of one chain's forward, in float64 (for near_ties)."""
    from facl_tpu_torch.ops.sa_bwd import _fold_affine, _h_from_p
    mul2, shift2 = _fold_affine(lp2, *stats[1], eps)
    mul3, shift3 = _fold_affine(lp3, *stats[2], eps)
    h2 = _h_from_p(p2, mul2, shift2).double()
    return (h2 @ lp3.kernel.double() + lp3.bias.double()) * mul3.double() \
        + shift3.double()


def sa_chain_vs_f64(x3, layers, dpooled, pool, impl="pair3"):
    """The whole SA stage of ``impl`` — forward, then the backward for a
    given pooled cotangent — three times on the same card inputs:
    kernels (f32), twins (f32) and twins in float64. Every output
    (pooled, stats, gradients; not the BN-absorbed biases) must be as
    close to float64 as the twins are: relative L2 error at most
    max(2x the twins', 1e-6). Pool routing is a discrete choice where a
    group's pre-activation sits within round-off of a tie or of zero, and
    one flipped choice moves a whole dpooled entry (measured: 4e-4 on
    dbeta3 from such flips). So pair/pair3 give all three backwards the
    kernels' routing (argmax and dead-ReLU sentinel); hybrid/hybrid2 and
    pallas, whose routing is made inside B8a / B9, take a dpooled that is
    zero on the pairs near_ties finds in the float64 forward (tolerance
    1e-4 of the largest |z|). pallas also returns, and is held on, dx."""
    SP, SF, SB, SK = sa_modules()
    pair = impl in ("pair", "pair3")
    rows = x3.transpose(1, 2).reshape(-1, x3.shape[1]).contiguous()

    def fwd(dt):
        L = [SP.SALayerParams(*(t.to(dt) for t in lp)) for lp in layers]
        if pair:
            pooled, stats, res = SP.sa_forward_pair(x3.to(dt), L, pool, 1e-5)
        elif impl == "pallas":
            pooled, stats, packed = SK.sa_train_forward_unified(
                rows.to(dt), L, pool, 1e-5)
            res = dict(packed=packed)
        else:
            f = SF.sa_forward_4sweep if impl == "hybrid2" else SB._forward_ps
            pooled, stats, p1, p2 = f(rows.to(dt), L, pool, 1e-5)
            res = dict(p1=p1, p2=p2)
        outs = {"pooled": pooled}
        for i, (m, v) in enumerate(stats, 1):
            outs[f"mean{i}"], outs[f"var{i}"] = m, v
        return L, stats, res, outs

    def bwd(dt, L, stats, res, outs, route):
        if pair:
            grads = SP.sa_backward_pair(
                x3.to(dt), L, stats, dict(res, idx=route), dpooled.to(dt),
                pool, 1e-5, slim=impl == "pair3")
        elif impl == "pallas":
            outs["dx"], grads = SK.sa_train_backward_unified(
                rows.to(dt), L, res["packed"], route.to(dt), pool)
        else:
            grads = SB.sa_backward_2sweep(rows.to(dt), res["p1"], res["p2"],
                                          L, stats, route.to(dt), pool, 1e-5)
        for i, (dw, db, dg, dbe) in enumerate(grads, 1):
            outs.update({f"dW{i}": dw, f"dgamma{i}": dg, f"dbeta{i}": dbe})
        return {k: v.double() for k, v in outs.items()}

    with twins_on_card():
        f64 = fwd(torch.float64)
    note = ""
    if pair:
        fk = fwd(torch.float32)
        route = fk[2]["idx"]
    else:
        z = b9_z(rows.double(), f64[0], f64[2]["packed"]) \
            if impl == "pallas" else _z64(f64[2]["p2"], f64[1], *f64[0][1:])
        near = near_ties(z, pool, 1e-4 * float(z.abs().max()))
        del z
        route = torch.where(near, 0.0, dpooled)
        note = f"; dpooled zeroed on {int(near.sum())} near-tie pairs"
        fk = fwd(torch.float32)
    kern = bwd(torch.float32, *fk, route)
    with twins_on_card():
        twin = bwd(torch.float32, *fwd(torch.float32), route)
        ref = bwd(torch.float64, *f64, route)
    worst = {}
    for k in ref:
        ek, et = _rel_l2(kern[k], ref[k]), _rel_l2(twin[k], ref[k])
        check(ek <= max(2 * et, 1e-6), f"SA chain {impl} {k}: kernels "
                                       f"{ek:.2e} vs float64, twins {et:.2e}")
        worst[k] = (ek, et)
    wk = max(v[0] for v in worst.values())
    wt = max(v[1] for v in worst.values())
    print(f"SA chain {impl} K={pool} vs float64 ({len(ref)} outputs): worst "
          f"relative L2 kernels {wk:.2e}, twins {wt:.2e}{note}", flush=True)
    return wk, wt


SRC2 = "facl_tpu_torch/ops/csrc/sa_2sweep.cu"
#: The SA impls with kernels, in the order the main phase drives them.
IMPLS = ("pair3", "pair", "hybrid2", "hybrid")


def sweep2_err(k, t, name):
    """B6/B8b: every accumulator within 1e-4 of its max-abs, cnt1 exact."""
    check(torch.equal(k["cnt1"], t["cnt1"]), f"{name}: cnt1 not exact")
    return max(acc_err(k[n], t[n], f"{name} {n}") for n in t)


def sweep2_ops(C0, C1=64, C2=64):
    """Operations per row of B6/B8b past h1: h2 (3 C2); dy2 (2 C2 C2 +
    3 C2); q2 (C2 + 2 C2 C1); mq (C1); A2 (2 C2 C1); G1 (symmetric, C1
    (C1 + 1)); TM1 and the C0 U1 blocks ((C0 + 1)(2 C1 C1 + C1)); the four
    colsums (4 C1); T1x, P1 (4 C1 C0); Gx (symmetric, C0 (C0 + 1)); cx."""
    return (3 * C2 + 2 * C2 * C2 + 3 * C2 + C2 + 2 * C2 * C1 + C1
            + 2 * C2 * C1 + C1 * (C1 + 1) + (C0 + 1) * (2 * C1 * C1 + C1)
            + 4 * C1 + 4 * C1 * C0 + C0 * (C0 + 1) + C0)


def two_sweep_rows(x3, layers, dpooled, K):
    """B7 (both call shapes of B7a, B7b, B7c) and B8 (B8a, B8b) against
    their twins on the hybrid2 forward of the main path's tensors. B8a
    routes inside the kernel: its dpooled is zero on the near_ties pairs
    of a float64 recompute (tolerance 1e-5 of the largest |z|), where a
    kernel and a twin that sum in another order may route differently."""
    SP, SF, SB = sweep_modules()
    from facl_tpu_torch.ops.sa_bwd import _fold_affine, _layer_terms
    lp1, lp2, lp3 = layers
    eps = 1e-5
    Bc, C0, N = x3.shape
    R, P = Bc * N, Bc * N // K
    C1, C2, C3 = 64, 64, 256
    xr = x3.transpose(1, 2).reshape(R, C0).contiguous()    # channels-last
    rows = []

    def add(name, args, err, nbytes, ops, fn, replaces):
        rows.append(dict(name=name, args=args, err=err, nbytes=nbytes,
                         ops=ops, fn=fn, plain=getattr(SF if fn in
                                                       SF.KERNELS else SB,
                                                       fn.__name__ + "_plain"),
                         source=SRC2, replaces=replaces))

    a1 = (xr, lp1.kernel, lp1.bias)
    p1, s1, ss1 = SF.sa_fwd_layer_plain(*a1)
    k = SF.sa_fwd_layer(*a1)
    add("sa_fwd_layer (x->p1)", a1,
        max(row_err(k[0], p1, "B7a p1"), acc_err(k[1], s1, "B7a s1"),
            acc_err(k[2], ss1, "B7a ss1")),
        R * (C0 + C1) * 4, R * (2 * C0 * C1 + 4 * C1), SF.sa_fwd_layer,
        "facl_tpu/ops/pallas/sa_fwd.py:189")
    m1, v1 = SF._finalize(s1, ss1, R)
    mul1, shift1 = _fold_affine(lp1, m1, v1, eps)
    a2 = (p1, lp2.kernel, lp2.bias, mul1, shift1)
    p2, s2, ss2 = SF.sa_fwd_layer_plain(*a2)
    k = SF.sa_fwd_layer(*a2)
    add("sa_fwd_layer (p1->p2)", a2,
        max(row_err(k[0], p2, "B7a p2"), acc_err(k[1], s2, "B7a s2"),
            acc_err(k[2], ss2, "B7a ss2")),
        R * (C1 + C2) * 4, R * (3 * C1 + 2 * C1 * C2 + 4 * C2),
        SF.sa_fwd_layer, "facl_tpu/ops/pallas/sa_fwd.py:189")
    m2, v2 = SF._finalize(s2, ss2, R)
    mul2, shift2 = _fold_affine(lp2, m2, v2, eps)
    ag = (p2, mul2, shift2)
    G2, ch2 = SF.sa_fwd_gram_plain(*ag)
    k = SF.sa_fwd_gram(*ag)
    add("sa_fwd_gram", ag,
        max(acc_err(k[0], G2, "B7b G2"), acc_err(k[1], ch2, "B7b ch2")),
        R * C2 * 4, R * (3 * C2 + C2 * (C2 + 1) + C2), SF.sa_fwd_gram,
        "facl_tpu/ops/pallas/sa_fwd.py:219")
    m3, v3 = SF._moments_from_gram(G2, ch2, lp3.kernel, lp3.bias, R)
    mul3, shift3 = _fold_affine(lp3, m3, v3, eps)
    ap = (p2, mul2, shift2, lp3.kernel, lp3.bias, mul3, shift3, K)
    add("sa_fwd_pool", ap,
        row_err(SF.sa_fwd_pool(*ap), SF.sa_fwd_pool_plain(*ap), "B7c pooled"),
        R * C2 * 4 + P * C3 * 4, R * (3 * C2 + 2 * C2 * C3 + 4 * C3),
        SF.sa_fwd_pool, "facl_tpu/ops/pallas/sa_fwd.py:242")

    z = _z64(p2, [(m1, v1), (m2, v2), (m3, v3)], lp2, lp3)
    near = near_ties(z, K, 1e-5 * float(z.abs().max()))
    del z
    dp = torch.where(near, 0.0, dpooled)
    gi2 = lp2.scale * torch.rsqrt(v2 + eps)
    gi3 = lp3.scale * torch.rsqrt(v3 + eps)
    as1 = (p2, mul2, shift2, lp3.kernel, lp3.bias, mul3, shift3, gi3, dp, K)
    A3, u3, G2b, ch2b, q3 = SB.sa_bwd2_sweep1_plain(*as1)
    h2 = SB._h_from_p(p2, mul2, shift2)
    nnz = int((SB._dy_top((h2 @ lp3.kernel + lp3.bias) * mul3 + shift3, dp,
                          K) != 0).sum())
    del h2
    k = SB.sa_bwd2_sweep1(*as1)
    add("sa_bwd2_sweep1", as1,
        max(acc_err(k[0], A3, "B8a A3"), acc_err(k[1], u3, "B8a u3"),
            acc_err(k[2], G2b, "B8a G2"), acc_err(k[3], ch2b, "B8a ch2"),
            row_err(k[4], q3, "B8a q3")),
        2 * R * C2 * 4 + P * C3 * 4,
        R * (3 * C2 + 2 * C2 * C3 + 4 * C3 + C2 * (C2 + 1) + C2)
        + nnz * (4 * C2 + 2), SB.sa_bwd2_sweep1,
        "facl_tpu/ops/pallas/sa_bwd.py:275")
    print(f"B8a: dpooled zeroed on {int(near.sum())} of {near.numel()} "
          f"near-tie (group, channel) pairs; {nnz} nonzero dy3 entries "
          f"({nnz / max(int((dp != 0).sum()), 1):.2f} rows per routed pair)",
          flush=True)
    t3 = _layer_terms(A3, u3, lp3, m3, v3, G2b, ch2b, R, eps)
    as2 = (xr, p1, mul1, shift1, p2, mul2, shift2, q3, t3["M"].contiguous(),
           t3["rc"], gi2, lp2.kernel)
    add("sa_bwd2_sweep2", as2,
        sweep2_err(SB.sa_bwd2_sweep2(*as2), SB.sa_bwd2_sweep2_plain(*as2),
                   "B8b"),
        R * (C0 + 3 * C1) * 4, R * (3 * C1 + sweep2_ops(C0)),
        SB.sa_bwd2_sweep2, "facl_tpu/ops/pallas/sa_bwd.py:298")
    return rows


SRC_SEL = "facl_tpu_torch/ops/csrc/select.cu"
SRC_GA = "facl_tpu_torch/ops/csrc/gather.cu"
SRC9 = "facl_tpu_torch/ops/csrc/sa_fused.cu"


def grouping_rows(flat, S, K, r2, g):
    """B4, B5a and B5b against their twins on the main path's clouds: B4's
    idx bit-equal to its twin and to B1's; B5 on B4's idx (b5_rows)."""
    from facl_tpu_torch.ops import select as SEL
    Bc, N, C = flat.shape
    ki = SEL.select_knn_ball(flat, S, K, r2)
    check(torch.equal(ki, SEL.select_knn_ball_plain(flat, S, K, r2)),
          "B4: idx differ from the twin")
    check(torch.equal(ki, SEL.select_gather(flat, S, K, r2, True)[1]),
          "B4: idx differ from B1's")
    rows = [dict(name="select_knn_ball", args=(flat, S, K, r2), err=0.0,
                 nbytes=Bc * N * 3 * 4 + Bc * S * K * 4,
                 ops=Bc * S * N * 12, fn=SEL.select_knn_ball,
                 plain=SEL.select_knn_ball_plain, source=SRC_SEL,
                 replaces="facl_tpu/ops/pallas/select.py:258")]
    print(f"B4 select_knn_ball {tuple(flat.shape)} S={S} K={K}: idx "
          f"bit-equal to its twin and B1", flush=True)
    return rows + b5_rows(flat, ki.reshape(Bc, S * K), g, "main path")


def b5_rows(flat, idx, g, label):
    """B5a and B5b against their twins on one set of clouds and indices:
    B5a bit-equal; B5b (rows summed in a fixed order) within 1e-5 of the
    scale of index_add_ (atomics) and equal across two runs. Library
    calls: torch.gather on the int64 index (made once, outside the timed
    call: it is the library's own index type), and index_add_ into a
    zeroed output allocated inside the timed call, as B5b returns a fresh
    one."""
    from facl_tpu_torch.ops import gather as GA
    Bc, N, C = flat.shape
    R = idx.shape[1]
    check(torch.equal(GA.gather_rows(flat, idx),
                      GA.gather_rows_plain(flat, idx)),
          f"B5a [{label}]: not bit-equal")
    i64 = idx.long()[..., None].expand(Bc, R, C)
    gr = torch.randn(Bc, R, C, generator=g).to(flat.device)
    k, t = GA.scatter_add_rows(idx, gr, N), GA.scatter_add_rows_plain(idx,
                                                                      gr, N)
    err = float((k - t).abs().max())
    check(err <= 1e-5 * float(t.abs().max()),
          f"B5b [{label}]: {err:.3e} from index_add_ beyond 1e-5 x scale")
    check(torch.equal(k, GA.scatter_add_rows(idx, gr, N)),
          f"B5b [{label}]: two runs differ")
    flat_i = (idx.long() + N * torch.arange(Bc, device=flat.device)[:, None]
              ).reshape(-1)
    gflat = gr.reshape(-1, C)
    per_point = torch.zeros(Bc, N, device=flat.device).scatter_add_(
        1, idx.long(), torch.ones(Bc, R, device=flat.device))
    top = float(per_point.topk(64, 1).values.sum()) / (Bc * R)
    print(f"B5 [{label}] {tuple(flat.shape)}, R={R}: the 64 most-hit points "
          f"of a cloud own {top:.3f} of its rows; B5a gather_rows "
          f"bit-equal; B5b scatter_add_rows {err:.3e} from index_add_, "
          "deterministic", flush=True)
    return [dict(name="gather_rows", args=(flat, idx), err=0.0,
                 nbytes=(Bc * N * C + Bc * R + Bc * R * C) * 4,
                 ops=0, fn=GA.gather_rows, plain=GA.gather_rows_plain,
                 library=lambda: torch.gather(flat, 1, i64),
                 source=SRC_GA, replaces="facl_tpu/ops/pallas/gather.py:72"),
            dict(name="scatter_add_rows", args=(idx, gr, N), err=err,
                 nbytes=(Bc * R + Bc * R * C + Bc * N * C) * 4,
                 ops=Bc * R * C, fn=GA.scatter_add_rows,
                 plain=GA.scatter_add_rows_plain,
                 library=lambda: torch.zeros(Bc * N, C, device=flat.device)
                 .index_add_(0, flat_i, gflat),
                 source=SRC_GA, replaces="facl_tpu/ops/pallas/gather.py:126")]


def b9_ops(widths, C0, sweep, target=-1):
    """f32 operations per row of one B9 launch, from the TPU kernel's own
    recomputes: a layer costs 2 cin w for its product and 4 w for bias,
    affine and ReLU; stats sweeps 4 w more for the sums; the pool 1 per
    top element, its cotangent split 3; the backward per layer 8 w for
    mask, xhat and dp (6 w for the target's sums), 2 cin w for da = dp
    W^T below the top, and in the final sweep 2 cin w + w for dW and db
    and the dx product."""
    cins = [C0] + list(widths[:-1])
    L = len(widths)

    def fwd(n):
        return sum(2 * cins[l] * widths[l] + 4 * widths[l] for l in range(n))
    if sweep == "stats":
        return fwd(target) + 2 * cins[target] * widths[target] \
            + 4 * widths[target]
    if sweep == "pool":
        return fwd(L) + widths[-1]
    ops = fwd(L) + 3 * widths[-1]
    stop = target if sweep == "bnsum" else -1
    for l in range(L - 1, stop, -1):
        ops += 8 * widths[l]
        if l or sweep == "final":
            ops += 2 * cins[l] * widths[l]            # da (dx at l = 0)
        if sweep == "final":
            ops += 2 * cins[l] * widths[l] + widths[l]
    if sweep == "bnsum":
        ops += 6 * widths[target]
    return ops


def b9_rows(xr, layers, K, dpooled):
    """B9's eight launches of a main-path step (three stats sweeps, the
    pool sweep, three BN-sum sweeps, the final sweep) against their twins
    on the same card tensors, each fed its twin's inputs: sums and dW to
    1e-4 of their max-abs (stats to 1e-5), pooled and dx at rtol 1e-5 /
    atol 1e-5 x scale, db (exactly zero: a BatchNorm follows each Dense)
    near zero. dpooled is zero on the near_ties pairs of a float64
    recompute (tolerance 1e-5 of the largest |z|), where a kernel and a
    twin that sum in another order may route differently."""
    from facl_tpu_torch.ops import sa_kernel as SK
    from facl_tpu_torch.ops.sa_fwd import _finalize
    R, C0 = xr.shape
    widths = [lp.kernel.shape[1] for lp in layers]
    L, P, eps = len(layers), R // K, 1e-5
    rows = []

    def add(name, args, err, nbytes, ops, fn):
        rows.append(dict(name=name, args=args, err=err, nbytes=nbytes,
                         ops=R * ops, fn=fn,
                         plain=getattr(SK, fn.__name__ + "_plain"),
                         source=SRC9,
                         replaces="facl_tpu/ops/pallas/sa_kernel.py:282"
                         if fn in (SK.sa_fused_stats, SK.sa_fused_pool) else
                         "facl_tpu/ops/pallas/sa_kernel.py:480"))

    packed = torch.zeros(L, 2, max(widths), device=xr.device)
    for l, w in enumerate(widths):
        a = (xr, layers, packed.clone(), K, l)
        k, t = SK.sa_fused_stats(*a), SK.sa_fused_stats_plain(*a)
        err = 0.0
        for kk, tt, n in zip(k, t, ("sum p", "sum p^2")):
            e = float((kk - tt).abs().max())
            check(e <= 1e-5 * float(tt.abs().max()),
                  f"B9 stats layer {l} {n}: {e:.3e} beyond 1e-5 x scale")
            err = max(err, e)
        add(f"sa_fused_stats (layer {l})", a, err, R * C0 * 4,
            b9_ops(widths, C0, "stats", l), SK.sa_fused_stats)
        mean, var = _finalize(t[0], t[1], R)
        packed[l, 0, :w], packed[l, 1, :w] = mean, torch.rsqrt(var + eps)
    a = (xr, layers, packed, K)
    add("sa_fused_pool", a, row_err(SK.sa_fused_pool(*a),
                                    SK.sa_fused_pool_plain(*a), "B9 pooled"),
        R * C0 * 4 + P * widths[-1] * 4, b9_ops(widths, C0, "pool"),
        SK.sa_fused_pool)

    z = b9_z(xr.double(), layers, packed)
    near = near_ties(z, K, 1e-5 * float(z.abs().max()))
    del z
    dp = torch.where(near, 0.0, dpooled)
    bsums = torch.zeros_like(packed)
    for l in reversed(range(L)):
        a = (xr, layers, packed, bsums.clone(), dp, K, l)
        k, t = SK.sa_fused_bnsum(*a), SK.sa_fused_bnsum_plain(*a)
        add(f"sa_fused_bnsum (layer {l})", a,
            max(acc_err(k[0], t[0], f"B9 bnsum {l} sum dy"),
                acc_err(k[1], t[1], f"B9 bnsum {l} sum dy xhat")),
            R * C0 * 4 + P * widths[-1] * 4,
            b9_ops(widths, C0, "bnsum", l), SK.sa_fused_bnsum)
        bsums[l, 0, :widths[l]], bsums[l, 1, :widths[l]] = t
    a = (xr, layers, packed, bsums, dp, K, True)
    (kd, kw, kb), (td, tw, tb) = SK.sa_fused_final(*a), \
        SK.sa_fused_final_plain(*a)
    err = max([row_err(kd, td, "B9 dx")] +
              [acc_err(kk, tt, f"B9 dW{l}") for l, (kk, tt) in
               enumerate(zip(kw, tw))])
    gscale = max(float(t.abs().max()) for t in tw)
    for l, (kk, tt) in enumerate(zip(kb, tb)):
        check(max(float(kk.abs().max()), float(tt.abs().max())) <
              1e-4 * gscale, f"B9 db{l} (exactly zero) not near zero")
    add("sa_fused_final", a, err, 2 * R * C0 * 4 + P * widths[-1] * 4,
        b9_ops(widths, C0, "final"), SK.sa_fused_final)
    print(f"B9: dpooled zeroed on {int(near.sum())} of {near.numel()} "
          "near-tie (group, channel) pairs; every sweep within its bars",
          flush=True)
    return rows


def check_b2b_b3(x3, layers, K, dpooled, label):
    """B2b (sa_fwd_gram_pool) and B3a-B3c (sa_bwd_sweep1-3) against their
    twins on one grouping's tensors, at phase_kernels' bars, and run to
    run bit-identical (the fine variant's K = 128: pool groups spanning
    two of the sweeps' 64-row tiles)."""
    SP = sweep_modules()[0]
    from facl_tpu_torch.ops.sa_bwd import _fold_affine, _h_from_p, \
        _layer_terms
    from facl_tpu_torch.ops.sa_fwd import _finalize
    lp1, lp2, lp3 = layers
    Bc, C0, N = x3.shape
    R, eps = Bc * N, 1e-5
    m1, v1 = SP._moments_from_gram(torch.einsum("bcn,bdn->cd", x3, x3),
                                   x3.sum((0, 2)), lp1.kernel, lp1.bias, R)
    mul1, shift1 = _fold_affine(lp1, m1, v1, eps)
    p2, s2, ss2 = SP.sa_fwd_layer12_plain(x3, lp1.kernel, lp1.bias, mul1,
                                          shift1, lp2.kernel, lp2.bias)
    m2, v2 = _finalize(s2, ss2, R)
    mul2, shift2 = _fold_affine(lp2, m2, v2, eps)
    agp = (p2, mul2, shift2, lp3.kernel, lp3.bias, K)
    k, t = SP.sa_fwd_gram_pool(*agp), SP.sa_fwd_gram_pool_plain(*agp)
    check(all(torch.equal(a, b) for a, b in
              zip(k, SP.sa_fwd_gram_pool(*agp))),
          f"gram_pool [{label}]: two runs differ")
    p3 = (_h_from_p(p2, mul2, shift2) @ lp3.kernel + lp3.bias).reshape(
        R // K, K, -1)
    e = max(acc_err(k[0], t[0], f"gram_pool [{label}] G2"),
            acc_err(k[1], t[1], f"gram_pool [{label}] ch2"),
            row_err(k[2], t[2], f"gram_pool [{label}] max"),
            row_err(k[3], t[3], f"gram_pool [{label}] min"))
    nmis = index_err(k[4], t[4], p3, t[2], f"gram_pool [{label}] argmax") \
        + index_err(k[5], t[5], p3, t[3], f"gram_pool [{label}] argmin")
    del p3
    G2, ch2, mx, mn, imx, imn = t
    m3, v3 = SP._moments_from_gram(G2, ch2, lp3.kernel, lp3.bias, R)
    mul3, shift3 = _fold_affine(lp3, m3, v3, eps)
    sel = mul3 >= 0
    zstar = torch.where(sel, mx, mn) * mul3 + shift3
    idx = torch.where(zstar > 0, torch.where(sel, imx, imn),
                      torch.full_like(imx, K))
    gi2 = lp2.scale * torch.rsqrt(v2 + eps)
    gi3 = lp3.scale * torch.rsqrt(v3 + eps)
    as1 = (p2, mul2, shift2, dpooled, idx, gi3, lp3.kernel, K)
    k, t = SP.sa_bwd_sweep1(*as1), SP.sa_bwd_sweep1_plain(*as1)
    check(all(torch.equal(a, b) for a, b in zip(k, SP.sa_bwd_sweep1(*as1))),
          f"sweep1 [{label}]: two runs differ")
    e1 = max(acc_err(k[0], t[0], f"sweep1 [{label}] A3"),
             acc_err(k[1], t[1], f"sweep1 [{label}] u3"),
             row_err(k[2], t[2], f"sweep1 [{label}] q3"))
    A3, u3, q3 = t
    t3 = _layer_terms(A3, u3, lp3, m3, v3, G2, ch2, R, eps)
    as2 = (x3, lp1.kernel, lp1.bias, mul1, shift1, p2, mul2, shift2, q3,
           t3["M"].contiguous(), t3["rc"], gi2, lp2.kernel)
    k, t = SP.sa_bwd_sweep2(*as2), SP.sa_bwd_sweep2_plain(*as2)
    check(all(torch.equal(a, b) for a, b in zip(k, SP.sa_bwd_sweep2(*as2))),
          f"sweep2 [{label}]: two runs differ")
    e2 = max([acc_err(a, b, f"sweep2 [{label}] {n}") for a, b, n in
              zip(k[:4], t[:4], ("A2", "G1", "u2", "ch1"))] +
             [row_err(k[4], t[4], f"sweep2 [{label}] mq")])
    A2, G1, u2, ch1, mq = t
    t2 = _layer_terms(A2, u2, lp2, m2, v2, G1, ch1, R, eps)
    as3 = (x3, lp1.kernel, lp1.bias, mul1, shift1, mq, t2["M"].contiguous(),
           t2["rc"])
    k, t = SP.sa_bwd_sweep3(*as3), SP.sa_bwd_sweep3_plain(*as3)
    check(all(torch.equal(a, b) for a, b in zip(k, SP.sa_bwd_sweep3(*as3))),
          f"sweep3 [{label}]: two runs differ")
    e3 = max(acc_err(k[0], t[0], f"sweep3 [{label}] A1"),
             acc_err(k[1], t[1], f"sweep3 [{label}] u1"))
    print(f"B2b/B3 [{label}] K={K}, R={R}: gram_pool max |kernel - twin| "
          f"{e:.3e}, {nmis} pool indices differ, all at twin ties; sweep1 "
          f"{e1:.3e}, sweep2 {e2:.3e}, sweep3 {e3:.3e}; all four run to run "
          "bit-identical", flush=True)


def phase_kernels(dev, model, points):
    """Each kernel against its twin on real main-path tensors."""
    from facl_tpu_torch.ops import sa_pair as SP
    from facl_tpu_torch.ops import select as SEL
    from facl_tpu_torch.ops.sa_bwd import _fold_affine, _layer_terms
    from facl_tpu_torch.ops.sa_fwd import _finalize

    rows = []
    G, B, N, C = points.shape
    flat = points.transpose(0, 1).reshape(B * G, N, C).contiguous()
    S = K = 64
    r2 = 0.06

    def b1_case(name, pts, radius, S=S, K=K):
        kg, ki = SEL.select_gather(pts, S, K, radius, return_idx=True)
        tg, ti = SEL.select_gather_plain(pts, S, K, radius)
        torch.cuda.synchronize()
        check(torch.equal(ki, ti), f"B1 {name}: idx differ")
        check(torch.equal(kg, tg), f"B1 {name}: grouped differ")
        print(f"B1 select_gather [{name}] {tuple(pts.shape)} S={S} K={K}: "
              "bit-equal", flush=True)
        return kg

    b1_case("random", flat, r2)
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    half = torch.rand(flat.shape[0], N // 2, C, generator=g) - 0.5
    b1_case("duplicates", torch.cat([half, half], 1).to(dev), 0.2)
    far = torch.randn(flat.shape, generator=g) * 10.0
    b1_case("all-out-of-radius", far.to(dev), 1e-6)
    Bc = flat.shape[0]
    rows.append(dict(name="select_gather", args=(flat, S, K, r2), err=0.0,
                     nbytes=Bc * N * C * 4 + Bc * C * S * K * 4,
                     ops=Bc * S * N * 12, fn=SEL.select_gather,
                     plain=SEL.select_gather_plain, source=SRC_SEL,
                     replaces="facl_tpu/ops/pallas/select.py:302"))
    rows += grouping_rows(flat, S, K, r2, g)
    # B5 again on spread rows: phase_input_grad's clouds (xyz uniform in a
    # 0.8 cube) at the main path's Bc, from a generator of their own so
    # that the draws of g below stay as they were.
    gc = torch.Generator().manual_seed(SEED + 5)
    cube = torch.cat([torch.rand(Bc, N, 3, generator=gc) * 0.8 - 0.4,
                      torch.randn(Bc, N, 1, generator=gc)], 2).to(dev)
    cube_rows = b5_rows(cube, SEL.select_knn_ball(cube, S, K, r2).reshape(
        Bc, S * K), gc, "0.8 cube")

    # Real SA inputs: the grouped clouds and the model's SA weights.
    grouped, _ = SEL.select_gather(flat, S, K, r2)
    grouped[:, :3] -= flat[:, :S, :3].transpose(1, 2)[..., None]
    x3 = grouped.reshape(Bc, C, S * K)
    R, P = Bc * S * K, Bc * S
    lp1, lp2, lp3 = (tuple(t.detach() for t in lp)
                     for lp in model.sa_stage.layers())
    lp1, lp2, lp3 = (SP.SALayerParams(*t) for t in (lp1, lp2, lp3))
    C0, C1, C2, C3 = C, 64, 64, 256
    eps = 1e-5
    with torch.no_grad():
        Gx = torch.einsum("bcn,bdn->cd", x3, x3)
        cx = x3.sum((0, 2))
        m1, v1 = SP._moments_from_gram(Gx, cx, lp1.kernel, lp1.bias, R)
        mul1, shift1 = _fold_affine(lp1, m1, v1, eps)
        a12 = (x3, lp1.kernel, lp1.bias, mul1, shift1, lp2.kernel, lp2.bias)
        p2, s2, ss2 = SP.sa_fwd_layer12_plain(*a12)
        m2, v2 = _finalize(s2, ss2, R)
        mul2, shift2 = _fold_affine(lp2, m2, v2, eps)
        agp = (p2, mul2, shift2, lp3.kernel, lp3.bias, K)
        G2, ch2, mx, mn, imx, imn = SP.sa_fwd_gram_pool_plain(*agp)
        m3, v3 = SP._moments_from_gram(G2, ch2, lp3.kernel, lp3.bias, R)
        mul3, shift3 = _fold_affine(lp3, m3, v3, eps)
        sel = mul3 >= 0
        zstar = torch.where(sel, mx, mn) * mul3 + shift3
        idx = torch.where(zstar > 0, torch.where(sel, imx, imn),
                          torch.full_like(imx, K))
        dpooled = torch.randn(P, C3, generator=g).to(dev)
        gi2 = lp2.scale * torch.rsqrt(v2 + eps)
        gi3 = lp3.scale * torch.rsqrt(v3 + eps)
        as1 = (p2, mul2, shift2, dpooled, idx, gi3, lp3.kernel, K)
        A3, u3, q3 = SP.sa_bwd_sweep1_plain(*as1)
        t3 = _layer_terms(A3, u3, lp3, m3, v3, G2, ch2, R, eps)
        as2 = (x3, lp1.kernel, lp1.bias, mul1, shift1, p2, mul2, shift2, q3,
               t3["M"].contiguous(), t3["rc"], gi2, lp2.kernel)
        A2, G1, u2, ch1, mq = SP.sa_bwd_sweep2_plain(*as2)
        t2 = _layer_terms(A2, u2, lp2, m2, v2, G1, ch1, R, eps)
        as3 = (x3, lp1.kernel, lp1.bias, mul1, shift1, mq,
               t2["M"].contiguous(), t2["rc"])

        # B2 sweep A
        kp2, ks, kss = SP.sa_fwd_layer12(*a12)
        e = max(row_err(kp2, p2, "layer12 p2"), acc_err(ks, s2, "layer12 s"),
                acc_err(kss, ss2, "layer12 ss"))
        ops = R * (2 * C0 * C1 + 4 * C1 + 2 * C1 * C2 + 4 * C2)
        rows.append(dict(name="sa_fwd_layer12", args=a12, err=e,
                         nbytes=R * (C0 + C2) * 4, ops=ops,
                         fn=SP.sa_fwd_layer12,
                         plain=SP.sa_fwd_layer12_plain,
                         replaces="facl_tpu/ops/pallas/sa_pair.py:634"))
        # B2 sweep B
        kG, kch, kmx, kmn, kimx, kimn = SP.sa_fwd_gram_pool(*agp)
        h2 = torch.relu(p2 * mul2 + shift2)
        p3 = (h2 @ lp3.kernel + lp3.bias).reshape(P, K, C3)
        del h2
        e = max(acc_err(kG, G2, "gram_pool G2"),
                acc_err(kch, ch2, "gram_pool ch2"),
                row_err(kmx, mx, "gram_pool max"),
                row_err(kmn, mn, "gram_pool min"))
        nmis = index_err(kimx, imx, p3, mx, "gram_pool argmax") + \
            index_err(kimn, imn, p3, mn, "gram_pool argmin")
        del p3
        print(f"gram_pool: {nmis} pool indices differ, all at twin ties",
              flush=True)
        # Gram(h2) is symmetric: C2 (C2 + 1) operations per row suffice.
        # Its products run on tensor cores (3xTF32), the rest on CUDA cores.
        rows.append(dict(name="sa_fwd_gram_pool", args=agp, err=e,
                         nbytes=R * C2 * 4 + 4 * P * C3 * 4,
                         ops=R * (3 * C2 + C2 + C3 + 2 * C3),
                         tc_ops=R * (C2 * (C2 + 1) + 2 * C2 * C3),
                         fn=SP.sa_fwd_gram_pool,
                         plain=SP.sa_fwd_gram_pool_plain,
                         replaces="facl_tpu/ops/pallas/sa_pair.py:660"))
        # B3 sweep 1 (dy3 has one nonzero per live (group, channel))
        kA3, ku3, kq3 = SP.sa_bwd_sweep1(*as1)
        e = max(acc_err(kA3, A3, "sweep1 A3"), acc_err(ku3, u3, "sweep1 u3"),
                row_err(kq3, q3, "sweep1 q3"))
        check(all(torch.equal(a, b) for a, b in
                  zip((kA3, ku3, kq3), SP.sa_bwd_sweep1(*as1))),
              "sweep1: two runs differ")
        nnz = int((idx < K).sum())
        hits = torch.zeros(P, K + 1, device=dev).scatter_add_(
            1, idx.long(), torch.ones(P, C3, device=dev))[:, :K]
        print(f"sweep1: {nnz} live (group, channel) entries of {P * C3}; a "
              f"group's most-hit row takes {float(hits.amax(1).sum()) / nnz:.3f}"
              " of its live entries", flush=True)
        rows.append(dict(name="sa_bwd_sweep1", args=as1, err=e,
                         nbytes=2 * R * C2 * 4 + P * C3 * 8,
                         ops=nnz * (4 * C2 + 2) + R * 3 * C2,
                         fn=SP.sa_bwd_sweep1, plain=SP.sa_bwd_sweep1_plain,
                         replaces="facl_tpu/ops/pallas/sa_pair.py:772"))
        # B3 sweep 2
        kA2, kG1, ku2, kch1, kmq = SP.sa_bwd_sweep2(*as2)
        e = max(acc_err(kA2, A2, "sweep2 A2"), acc_err(kG1, G1, "sweep2 G1"),
                acc_err(ku2, u2, "sweep2 u2"),
                acc_err(kch1, ch1, "sweep2 ch1"),
                row_err(kmq, mq, "sweep2 mq"))
        # G1 = h1^T h1 is symmetric: C1 (C1 + 1) operations per row. The
        # products (h2 M3, q2, A2, G1) run on tensor cores (3xTF32).
        rows.append(dict(name="sa_bwd_sweep2", args=as2, err=e,
                         nbytes=R * (C0 + 2 * C2 + C1) * 4,
                         ops=R * (2 * C0 * C1 + 4 * C1 + 3 * C2 + 4 * C2
                                  + C1 + C1 + C2),
                         tc_ops=R * (2 * C2 * C2 + 2 * C2 * C1 + 2 * C2 * C1
                                     + C1 * (C1 + 1)),
                         fn=SP.sa_bwd_sweep2, plain=SP.sa_bwd_sweep2_plain,
                         replaces="facl_tpu/ops/pallas/sa_pair.py:800"))
        # B3 sweep 3
        kA1, ku1 = SP.sa_bwd_sweep3(*as3)
        A1, u1 = SP.sa_bwd_sweep3_plain(*as3)
        e = max(acc_err(kA1, A1, "sweep3 A1"), acc_err(ku1, u1, "sweep3 u1"))
        check(all(torch.equal(a, b) for a, b in
                  zip((kA1, ku1), SP.sa_bwd_sweep3(*as3))),
              "sweep3: two runs differ")
        print("sweep1, sweep3: run to run bit-identical", flush=True)
        # h1 and dy1 on CUDA cores; h1 M2 and dy1^T [x | 1] on tensor
        # cores (3xTF32).
        rows.append(dict(name="sa_bwd_sweep3", args=as3, err=e,
                         nbytes=R * (C0 + C1) * 4,
                         ops=R * (2 * C0 * C1 + 4 * C1 + 3 * C1),
                         tc_ops=R * (2 * C1 * C1 + 2 * C1 * (C0 + 1)),
                         fn=SP.sa_bwd_sweep3, plain=SP.sa_bwd_sweep3_plain,
                         replaces="facl_tpu/ops/pallas/sa_pair.py:835"))
        # B6: sweep 2 of the pair (non-slim) backward, on B3b's inputs.
        km = SP.sa_bwd_sweep2_full(*as2)
        e = sweep2_err(km, SP.sa_bwd_sweep2_full_plain(*as2), "B6")
        rows.append(dict(name="sa_bwd_sweep2_full", args=as2, err=e,
                         nbytes=R * (C0 + 2 * C2) * 4,
                         ops=R * (2 * C0 * C1 + C1 + sweep2_ops(C0)),
                         fn=SP.sa_bwd_sweep2_full,
                         plain=SP.sa_bwd_sweep2_full_plain, source=SRC2,
                         replaces="facl_tpu/ops/pallas/sa_pair.py:863"))
        del km
        rows += two_sweep_rows(x3, (lp1, lp2, lp3), dpooled, K)
        rows += b9_rows(x3.transpose(1, 2).reshape(R, C0).contiguous(),
                        [lp1, lp2, lp3], K, dpooled)
        torch.cuda.synchronize()
        for impl in IMPLS + ("pallas",):
            sa_chain_vs_f64(x3, [lp1, lp2, lp3], dpooled, K, impl)

        # The fine variant's grouping (S=32, K=128): B1, and pool groups
        # that span two of the sweeps' 64-row tiles.
        Sf, Kf = 32, 128
        gf = b1_case("fine", flat, r2, Sf, Kf)
        gf[:, :3] -= flat[:, :Sf, :3].transpose(1, 2)[..., None]
        dpf = torch.randn(Bc * Sf, C3, generator=g).to(dev)
        check_b2b_b3(gf.reshape(Bc, C, Sf * Kf), [lp1, lp2, lp3], Kf, dpf,
                     "fine")
        for impl in IMPLS + ("pallas",):
            sa_chain_vs_f64(gf.reshape(Bc, C, Sf * Kf), [lp1, lp2, lp3], dpf,
                            Kf, impl)

        for r in rows + cube_rows:
            measure(r)
    for r in rows:
        print_row(r)
    for r in cube_rows:
        print_row(r, " [0.8 cube]")
    return rows


def measure(r):
    """Time one row's kernel, twin and library call (device_ms) and set
    its bound from the row's bytes and operations."""
    args, fn, plain = r.pop("args"), r["fn"], r.pop("plain")
    r["ms"], r["host_us"] = device_ms(lambda: fn(*args))
    r["plain_ms"] = device_ms(lambda: plain(*args))[0]
    lib = r.pop("library", None)
    r["library_ms"] = device_ms(lib)[0] if lib else None
    nbytes, ops, tc = r.pop("nbytes"), r.pop("ops"), r.pop("tc_ops", 0)
    r["bound_ms"], r["bound_by"] = bound(nbytes, ops, tc)
    if tc:
        r["bound_f32_ms"] = bound(nbytes, ops + tc)[0]
    if PARENT and fn.__name__ in PARENT_AB:
        r["parent_ab"] = parent_ab(fn, args)
    r["max_abs_err"] = r.pop("err")
    r.setdefault("source", "facl_tpu_torch/ops/csrc/sa_pair.cu")


#: --parent: the parent tree's sa_pair library, and the kernels whose
#: launchers are timed against this tree's (wrapper -> (launcher name, the
#: blocks per SM the parent's wrapper launches it with)).
PARENT = {}
PARENT_AB = {"sa_fwd_gram_pool": ("facl_sa_fwd_gram_pool", 1),
             "sa_bwd_sweep1": ("facl_sa_bwd_sweep1", 2),
             "sa_bwd_sweep2": ("facl_sa_bwd_sweep2", 1),
             "sa_bwd_sweep3": ("facl_sa_bwd_sweep3", 2)}


def start_parent_build(root: str):
    """Start nvcc on ``root``'s sa_pair.cu (a checkout of the parent
    commit) with this tree's flags; returns the process and its output."""
    from facl_tpu_torch.ops import _build
    src = os.path.join(root, "facl_tpu_torch", "ops", "csrc", "sa_pair.cu")
    check(os.path.exists(src), f"--parent: no {src}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "parent-sa_pair.so"
    return subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                             str(out), src], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def load_parent(started) -> None:
    import ctypes
    proc, out = started
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"--parent: nvcc failed:\n{log}")
    lib = ctypes.CDLL(str(out))
    lib.facl_error_string.argtypes = [ctypes.c_int]
    lib.facl_error_string.restype = ctypes.c_char_p
    PARENT["lib"] = lib
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas parent sa_pair: {line.strip()}", flush=True)


def parent_ab(fn, args):
    """Device ms of wrapper ``fn`` on ``args`` with the parent tree's
    launcher (at the parent's grid for it) and with this tree's, in turns:
    parent, this tree, this tree, parent. The launchers' C signatures are
    the same in both trees."""
    import ctypes
    from facl_tpu_torch.ops import _build
    from facl_tpu_torch.ops import sa_pair as SP
    launcher, parent_per_sm = PARENT_AB[fn.__name__]
    key = ("sa_pair", launcher)
    ours = _build._FUNCTIONS[key]          # resolved by the timed calls
    lib = PARENT["lib"]
    pfn = getattr(lib, key[1])
    pfn.argtypes, pfn.restype = ours[1].argtypes, ctypes.c_int

    def parent_grid(t, R, per_sm=2):
        return min(R // 64, parent_per_sm * _build.sm_count(t.device))

    def run_parent():
        _build._FUNCTIONS[key] = (lib, pfn)
        try:
            with swapped([(SP, "grid", parent_grid)]):
                return device_ms(lambda: fn(*args))[0]
        finally:
            _build._FUNCTIONS[key] = ours

    def run_ours():
        return device_ms(lambda: fn(*args))[0]
    return [run_parent(), run_ours(), run_ours(), run_parent()]


def print_row(r, label=""):
    lib = "" if r["library_ms"] is None else \
        f", library {r['library_ms']:.4f} ms"
    tc = "" if "bound_f32_ms" not in r else \
        f" with products on tensor cores in 3xTF32 (f32 CUDA-core bound " \
        f"{r['bound_f32_ms']:.4f} ms)"
    print(f"kernel {r['name']}{label}: {r['ms']:.4f} ms on the device, "
          f"{r['host_us']:.1f} us on the host per call (twin "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']}{tc}{lib}), max |kernel - twin| = "
          f"{r['max_abs_err']:.3e}", flush=True)
    if "parent_ab" in r:
        ab = r["parent_ab"]
        print(f"  A/B {r['name']} in turns (parent, this tree, this tree, "
              f"parent): {' / '.join(f'{v:.4f}' for v in ab)} ms on the "
              f"device; parent mean {(ab[0] + ab[3]) / 2:.4f}, this tree "
              f"{(ab[1] + ab[2]) / 2:.4f}", flush=True)


def _cfg(batch, impl="pair3", select_impl="auto", gather_impl="auto"):
    import dataclasses
    from facl_tpu_torch.config import Config
    cfg = Config()
    return cfg.replace(train=dataclasses.replace(cfg.train, batch_size=batch),
                       model=dataclasses.replace(cfg.model, sa_impl=impl),
                       grouping=dataclasses.replace(
                           cfg.grouping, select_impl=select_impl,
                           gather_impl=gather_impl))


def _f64_grads(tr, pts, perm):
    """Loss, gradients and discrete decisions (``_decisions``) of the same
    step in float64 on the CPU: the yardstick of how far float32 itself
    moves this step."""
    from facl_tpu_torch.losses import circle_infonce, global_local_infonce
    from facl_tpu_torch.train.trainer import make_grouping_fn
    G, B = pts.shape[:2]
    model = tr.init_state(SEED).model.double().train()
    with torch.no_grad():
        neigh5, cent4 = make_grouping_fn(
            tr.g_cfg, "bcsk" if tr.cfg.model.channels_first else "bskc")(
            pts.transpose(0, 1))
    dec = {}
    with _decisions(model, tr.cfg.model.sa_impl, B, dec):
        x, _, _, x_global = model(
            neigh5.reshape(B * G, *neigh5.shape[2:]).double(),
            cent4.reshape(B * G, -1, 3).double())
        xg = x.reshape(B, G, -1).transpose(0, 1)
        loss = global_local_infonce(xg, x_global) + circle_infonce(xg, perm)
    loss.backward()
    return loss.item(), {n: p.grad.float() for n, p in
                         model.named_parameters() if p.grad is not None}, dec


def _rel_l2(a, b):
    return float((a - b).norm()) / max(float(b.norm()), 1e-30)


@contextlib.contextmanager
def sa_routing(store: list, impl: str):
    """Record the SA stage's pool routing of every forward into ``store``:
    for pair/pair3 the argmax residual (first index, dead-ReLU sentinel);
    for hybrid2 the rows B8a's rule routes to (relu(z) at the group's max,
    z > 0, ties split), recomputed by the plain ops from the forward's p2
    and statistics on the same device (on the card the kernel's own
    choice may differ from that recompute at near-ties); for pallas the
    same rule on B9's top layer (b9_decisions)."""
    if impl == "pallas":
        records = []
        with b9_decisions(records):
            yield
        store.extend(r[-1] for r in records)
        return
    SP, SF, SB = sweep_modules()
    pair = impl in ("pair", "pair3")
    mod, name = (SP, "sa_forward_pair") if pair else \
        (SF, "sa_forward_4sweep")
    fwd = getattr(mod, name)

    def capture(*args, **kwargs):
        out = fwd(*args, **kwargs)
        if pair:
            store.append(out[2]["idx"].cpu())
        else:
            _, (_, lp2, lp3), pool, eps = args
            mul2, shift2 = SB._fold_affine(lp2, *out[1][1], eps)
            mul3, shift3 = SB._fold_affine(lp3, *out[1][2], eps)
            z = (SB._h_from_p(out[3], mul2, shift2) @ lp3.kernel + lp3.bias) \
                * mul3 + shift3
            ones = torch.ones(z.shape[0] // pool, z.shape[1], device=z.device)
            store.append((SB._dy_top(z, ones, pool) != 0).cpu())
        return out
    setattr(mod, name, capture)
    try:
        yield
    finally:
        setattr(mod, name, fwd)


@contextlib.contextmanager
def _decisions(model, impl, B, dec: dict):
    """Record the discrete decisions of the forward run inside into
    ``dec``: the ReLU mask of every stage-2 and head BatchNorm output, the
    stage-2 local and global pool argmaxes, and the SA stage's pool
    routing (``sa_routing``)."""
    masks, seen, routes = {}, {}, []

    def keep(name):
        def hook(mod, inp, out):
            masks.setdefault(name, []).append(
                (out > 0).reshape(-1, out.shape[-1]).cpu())
        return hook
    mods = {f"stage2_mlp.{i}": getattr(model.stage2_mlp, f"BatchNorm_{i}")
            for i in range(model.stage2_mlp.n)}
    mods["head.0"] = model.head.BatchNorm_0     # called twice: local, global
    hooks = [m.register_forward_hook(keep(n)) for n, m in mods.items()]
    hooks.append(model.stage2_mlp.register_forward_hook(
        lambda mod, inp, out: seen.__setitem__("local", out.detach())))
    try:
        with sa_routing(routes, impl):
            yield
    finally:
        for h in hooks:
            h.remove()
    local = seen["local"]                                  # (B*G, S, F)
    dec.update({n: torch.cat(v) for n, v in masks.items()})
    dec["argmax_local"] = local.argmax(1).cpu()
    dec["argmax_global"] = local.reshape(B, -1, local.shape[-1]) \
        .argmax(1).cpu()
    dec["sa_route"] = routes[0]


def _step_decisions(d, B, pts, perm, impl, twins=False):
    """One step_fn on device ``d`` from the seed's weights (the SA sweeps'
    twins on the card with ``twins``). Returns the loss, the gradients and
    the step's discrete decisions (``_decisions``)."""
    from facl_tpu_torch.train import Trainer
    tr = Trainer(_cfg(B, impl), steps_per_epoch=100, device=d)
    st = tr.init_state(SEED)
    dec = {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(_decisions(st.model, impl, B, dec))
        if twins:
            stack.enter_context(twins_on_card())
        st, m = tr.step_fn(st, pts, perm=perm)
    grads = {n: p.grad.detach().cpu() for n, p in st.model.named_parameters()
             if p.grad is not None}
    return float(m["loss"]), grads, dec


def _touched(grads, flips, n2):
    """Which gradient entries a flipped decision can move (True), walking
    the layers from the loss down. A flip at a layer's ReLU, or at the
    pool above it, moves that layer's gradients in the flipped output
    channels only (the rows of an nn.Linear weight, BatchNorm is per
    channel) and every gradient below it in full. The SA stage counts as
    touched in full: its ReLU masks live inside the kernels and are not
    observed here (sa_chain_vs_f64 holds its precision on shared routing)."""
    pool2 = flips["argmax_local"] | flips["argmax_global"]
    layers = [(("head.Dense_1.",), None),
              (("head.Dense_0.", "head.BatchNorm_0."), flips["head.0"])]
    for i in reversed(range(n2)):
        ch = flips[f"stage2_mlp.{i}"]
        layers.append(((f"stage2_mlp.dense_{i}.",
                        f"stage2_mlp.BatchNorm_{i}."),
                       ch | pool2 if i == n2 - 1 else ch))
    out = {n: torch.ones_like(g, dtype=torch.bool) for n, g in grads.items()}
    below = False
    for prefixes, ch in layers:
        for n, g in grads.items():
            if not n.startswith(prefixes) or below:
                continue
            if ch is None:
                out[n] = torch.zeros_like(g, dtype=torch.bool)
            else:
                out[n] = (ch[:, None] if g.ndim == 2 else ch).expand(g.shape)
        below = below or (ch is not None and bool(ch.any()))
    return out


def _compare(gc, gk, touched, absorbed):
    """(worst relative L2 over the non-absorbed gradients, worst
    max-abs/scale over the entries no flip touches, that entry count,
    the fully untouched tensors' worst relative norm difference)."""
    worst_l2 = worst_free = worst_norm = 0.0
    n_free = 0
    for n, a in gc.items():
        if n in absorbed:
            continue
        b = gk[n]
        worst_l2 = max(worst_l2, _rel_l2(b, a))
        free = ~touched[n]
        if bool(free.any()):
            scale = max(float(a.abs().max()), float(b.abs().max()), 1e-8)
            worst_free = max(worst_free,
                             float((a - b)[free].abs().max()) / scale)
            n_free += int(free.sum())
        if bool(free.all()):
            worst_norm = max(worst_norm, abs(float(b.norm()) /
                                             float(a.norm()) - 1))
    return worst_l2, worst_free, n_free, worst_norm


def phase_cpu_vs_card(dev):
    """For pair3, pair, hybrid2 and pallas (between them B2, B3, B6, B7,
    B8, B9; hybrid adds no kernel): one step_fn on the CPU (twins) and on the card
    (kernels), same weights, points and permutation: loss at rtol 1e-4;
    BN-absorbed biases near zero; gradients at max-abs 2e-4 of their
    scale wherever no flipped decision reaches, and at relative L2 1e-2
    everywhere.

    Why two bars: the step's gradients are discontinuous in the
    activations. Each ReLU unit and pool argmax is a discrete decision;
    two f32 evaluations put the few that sit within round-off of a switch
    on different sides, and one flip moves a whole channel's gradient
    by up to ~1% of its scale (a row's contribution out of ~10^4), and
    everything below it in the network. So the script records every
    stage-2 and head ReLU mask, the stage-2 local/global argmaxes and
    the SA routing (``sa_routing``) on both devices, counts the flips, and
    holds the entries that no flip reaches (``_touched``) at the
    small-width parity tests' 2e-4. Everything is also held at relative
    L2 1e-2, and the same step with the SA sweeps' twins on the card is
    printed beside it: the gap that flips leave owes nothing to the
    kernels if the twins show it too. B=8, not 2: with 2 videos the
    global head BatchNorm normalises 2 rows per channel, whose outputs are
    +-1 whatever the input, so the gradient through it is a near-total
    cancellation and rounding noise."""
    G, B, N, C = 10, 8, 512, 4
    g = torch.Generator().manual_seed(SEED + 2)
    pts = torch.randn(G, B, N, C, generator=g)
    perm = torch.randperm(G, generator=g)
    for impl in IMPLS[:3] + ("pallas",):
        _cpu_vs_card(dev, impl, pts, perm)


def _cpu_vs_card(dev, impl, pts, perm):
    from facl_tpu_torch.train import Trainer
    B = pts.shape[1]
    lc, gc, dc = _step_decisions("cpu", B, pts, perm, impl)
    lk, gk, dk = _step_decisions(dev, B, pts, perm, impl)
    lt, gt, dt = _step_decisions(dev, B, pts, perm, impl, twins=True)
    l64, g64, d64 = _f64_grads(Trainer(_cfg(B, impl), 100, device="cpu"),
                               pts, perm)
    check(math.isclose(lk, lc, rel_tol=1e-4),
          f"cpu-vs-card {impl} loss {lk} vs {lc}")
    check(set(gc) == set(gk) == set(gt) == set(g64),
          "cpu-vs-card: gradient sets differ")
    # Parameters whose exact gradient is zero (a bias that a BatchNorm
    # downstream cancels) carry only round-off: held near zero instead.
    gscale = max(float(t.abs().max()) for t in g64.values())
    absorbed = {n for n in gc if float(g64[n].abs().max()) < 1e-9 * gscale}
    for n in absorbed:
        check(float(gc[n].abs().max()) < 1e-3 * gscale and
              float(gk[n].abs().max()) < 1e-3 * gscale,
              f"cpu-vs-card {impl}: BN-absorbed {n} not near zero")
    n2 = sum(1 for n in dc if n.startswith("stage2_mlp."))
    floor = max(_rel_l2(a, g64[n]) for n, a in gc.items()
                if n not in absorbed)
    readings = {}
    for label, dd, gg in (("card", dk, gk), ("card twins", dt, gt)):
        flips = {n: (dc[n] != dd[n]).reshape(-1, dc[n].shape[-1])
                 for n in dc}
        readings[label] = (
            {n: int(f.sum()) for n, f in flips.items()},
            _compare(gc, gg, _touched(gc, {n: f.any(0) for n, f in
                                           flips.items()}, n2), absorbed))
    counts, (l2, free, n_free, dnorm) = readings["card"]
    total = sum(t.numel() for n, t in gc.items() if n not in absorbed)
    r = dc["sa_route"]
    route = f"{r.numel()} pool indices" if impl.startswith("pair") else \
        f"{int(r.sum())} of {r.numel()} row entries routed on the cpu"
    print(f"cpu-vs-card {impl} B={B} step: loss cpu {lc:.6f} card {lk:.6f} "
          f"card twins {lt:.6f} (f64 {l64:.6f}); {len(gc)} gradients "
          f"({len(absorbed)} BN-absorbed); cpu f32-vs-f64 relative L2 "
          f"{floor:.3e}, with flipped decisions "
          f"{ {n: int((dc[n] != d64[n]).sum()) for n in dc} }; SA routing: "
          f"{route}", flush=True)
    for label, (cnt, (r_l2, r_free, r_n, r_norm)) in readings.items():
        print(f"  {label} vs cpu: flipped decisions {cnt} of "
              f"{ {n: dc[n].numel() for n in dc} }; relative L2 worst "
              f"{r_l2:.3e}; max-abs/scale worst {r_free:.3e} on the "
              f"{r_n} of {total} entries no flip reaches (norms "
              f"{r_norm:.1e})", flush=True)
    check(l2 <= 1e-2, f"cpu-vs-card {impl}: gradient relative L2 {l2:.3e} "
                      "> 1e-2")
    check(free <= 2e-4, f"cpu-vs-card {impl}: max-abs/scale {free:.3e} > "
                        "2e-4 where no decision flipped")
    check(dnorm <= 1e-3, f"cpu-vs-card {impl}: gradient norms differ by "
                         f"{dnorm:.3e} > 1e-3 where no decision flipped")


#: B9: L = 3 stats sweeps + the pool sweep, 3 BN-sum sweeps + the final.
B9_STEP = {"sa_fused_stats": 3, "sa_fused_pool": 1, "sa_fused_bnsum": 3,
           "sa_fused_final": 1}
ROUTES = (("pallas", "pallas"), ("pallas", "xla"), ("xla", "pallas"),
          ("xla", "xla"))
#: Launches of one input-gradient step per grouping route: B9's forward
#: and backward (final sweep with dx), and the route's grouping kernels
#: (B1 and B5a differentiate through the scatter-add B5b).
ROUTE_LAUNCHES = {
    ("pallas", "pallas"): dict(B9_STEP, select_gather=1, scatter_add_rows=1),
    ("pallas", "xla"): dict(B9_STEP, select_knn_ball=1),
    ("xla", "pallas"): dict(B9_STEP, gather_rows=1, scatter_add_rows=1),
    ("xla", "xla"): dict(B9_STEP),
}


@contextlib.contextmanager
def b9_decisions(store: list):
    """Record every B9 forward's discrete decisions into ``store``: the
    ReLU masks of the layers below the top and the top layer's pool
    routing (relu(z) at the group's max, z > 0), recomputed by the twins'
    ops from the forward's statistics on the same device."""
    from facl_tpu_torch.ops import sa_bwd as SB
    from facl_tpu_torch.ops import sa_kernel as SK
    fwd = SK.sa_train_forward_unified

    def capture(x, layers, pool, eps=1e-5):
        out = fwd(x, layers, pool, eps)
        v = SK.vectors(layers, out[2], None, x.shape[0])
        ps, _ = SK._forward_plain(x, layers, v, len(layers) - 1)
        masks = [(p * v[l, 3, :p.shape[1]] + v[l, 4, :p.shape[1]] > 0).cpu()
                 for l, p in enumerate(ps)]
        z = b9_z(x, layers, out[2])
        ones = torch.ones(z.shape[0] // pool, z.shape[1], device=z.device,
                          dtype=z.dtype)
        store.append(masks + [(SB._dy_top(z, ones, pool) != 0).cpu()])
        return out
    with swapped([(SK, "sa_train_forward_unified", capture)]):
        yield


def phase_input_grad(dev):
    """d(loss)/d(points) through each grouping route and
    SetAbstractionStage(impl="pallas", input_grad=True) — the path that
    launches B9's dx and the scatter-add B5b — at B=8 videos x 10 crops,
    N=512, S=K=64, widths 4-64-64-256: on the card with the kernels, on
    the card with every kernel's twin, and on the CPU (twins), from the
    same weights and points (xyz uniform in a 0.8 cube, so ~12% of each
    cloud lies in a centroid's ball and the gather term is real). loss =
    sum(sin(pooled) w). The gradient is held at relative L2 1e-2 and,
    where no ReLU or pool decision of the SA stage flipped between the
    devices, at max-abs 2e-4 of its scale (a flip moves the BatchNorm
    sums, so it reaches every entry: phase_cpu_vs_card). Launches per
    route are counted with the counters zeroed just before the card run.
    Returns {route label: launches}."""
    import copy
    from facl_tpu_torch.models.sa_stage import SetAbstractionStage
    from facl_tpu_torch.ops.grouping import group_points
    g = torch.Generator().manual_seed(SEED + 4)
    Bc, N, S, K = 80, 512, 64, 64
    pts = torch.cat([torch.rand(Bc, N, 3, generator=g) * 0.8 - 0.4,
                     torch.randn(Bc, N, 1, generator=g)], 2)
    w = torch.randn(256, generator=g)
    stage0 = SetAbstractionStage(4, (64, 64, 256), impl="pallas",
                                 input_grad=True, channels_first=False,
                                 generator=g)
    kernels = all_kernels()
    out = {}
    for route in ROUTES:
        def run(d, twins=False):
            stage = copy.deepcopy(stage0).to(d).train()
            p = pts.to(d, copy=True).requires_grad_(True)
            dec = []
            with contextlib.ExitStack() as stack:
                stack.enter_context(b9_decisions(dec))
                if twins:
                    stack.enter_context(twins_on_card())
                    stack.enter_context(grouping_twins_on_card())
                neigh, _ = group_points(p, S, K, 0.06, select_impl=route[0],
                                        gather_impl=route[1])
                (torch.sin(stage(neigh)) * w.to(d)).sum().backward()
            return p.grad.cpu(), dec[0]
        gc, dc = run("cpu")
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        gk, dk = run(dev)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels}
        want = ROUTE_LAUNCHES[route]
        for name, n in launches.items():
            check(n == want.get(name, 0), f"input grad {route}: kernel {name}"
                  f" launched {n} times, expected {want.get(name, 0)}")
        gt, dt = run(dev, twins=True)
        flips = [int((a != b).sum()) for a, b in zip(dc, dk)]
        tflips = [int((a != b).sum()) for a, b in zip(dc, dt)]
        scale = max(float(gc.abs().max()), 1e-30)
        l2, free = _rel_l2(gk, gc), float((gk - gc).abs().max()) / scale
        print(f"input grad select={route[0]} gather={route[1]}: |grad| max "
              f"{scale:.3e}, nonzero rows {int((gc.abs().sum(2) > 0).sum())}"
              f" of {Bc * N}; card vs cpu relative L2 {l2:.3e}, max-abs/scale"
              f" {free:.3e}, flipped decisions (ReLU layers 1-2, pool "
              f"routing) {flips}; card twins vs cpu {_rel_l2(gt, gc):.3e} / "
              f"{float((gt - gc).abs().max()) / scale:.3e}, flips {tflips}; "
              f"launches { {n: c for n, c in launches.items() if c} }",
              flush=True)
        check(l2 <= 1e-2, f"input grad {route}: relative L2 {l2:.3e} > 1e-2")
        if not any(flips):
            check(free <= 2e-4, f"input grad {route}: max-abs/scale "
                                f"{free:.3e} > 2e-4 with no flipped decision")
        out[f"input grad {route[0]}/{route[1]}"] = launches
    return out


#: Launches per step of each kernel wrapper on each impl's path.
PATHS = {
    "pair3": {"select_gather": 1, "sa_fwd_layer12": 1, "sa_fwd_gram_pool": 1,
              "sa_bwd_sweep1": 1, "sa_bwd_sweep2": 1, "sa_bwd_sweep3": 1},
    "pair": {"select_gather": 1, "sa_fwd_layer12": 1, "sa_fwd_gram_pool": 1,
             "sa_bwd_sweep1": 1, "sa_bwd_sweep2_full": 1},
    "hybrid2": {"select_gather": 1, "sa_fwd_layer": 2, "sa_fwd_gram": 1,
                "sa_fwd_pool": 1, "sa_bwd2_sweep1": 1, "sa_bwd2_sweep2": 1},
    "hybrid": {"select_gather": 1, "sa_bwd2_sweep1": 1, "sa_bwd2_sweep2": 1},
}
#: The pallas paths: (label, select_impl, gather_impl, timed steps,
#: launches per step).
PALLAS_PATHS = (
    ("pallas", "auto", "auto", 20, dict(B9_STEP, select_gather=1)),
    ("pallas B4", "pallas", "xla", 5, dict(B9_STEP, select_knn_ball=1)),
    ("pallas B5a", "xla", "pallas", 5, dict(B9_STEP, gather_rows=1)),
)


def phase_main(dev, profile: bool, card: str):
    """Each impl's Trainer at full width; returns {path: launches}."""
    kernels = all_kernels()
    cfg = _cfg(64)
    G, B = cfg.model.num_crops, cfg.train.batch_size
    N, C = cfg.data.num_points, cfg.model.in_features
    g = torch.Generator().manual_seed(SEED + 3)
    batches = torch.randn(2, G, B, N, C, generator=g).to(dev)
    out = {}
    for impl in IMPLS:
        out[impl] = _run_path(dev, impl, 40 if impl == "pair3" else 20,
                              batches, g, kernels, card, profile,
                              PATHS[impl])
        torch.cuda.empty_cache()
    for label, si, gi, steps, want in PALLAS_PATHS:
        out[label] = _run_path(dev, "pallas", steps, batches, g, kernels,
                               card, profile and label == "pallas", want,
                               label, si, gi)
        torch.cuda.empty_cache()
    return out


def all_kernels():
    """Every kernel wrapper of the port (each counts its launches)."""
    from facl_tpu_torch.ops import gather as GA
    from facl_tpu_torch.ops import select as SEL
    return SEL.KERNELS + GA.KERNELS + tuple(k for m in sa_modules()
                                            for k in m.KERNELS)


def _run_path(dev, impl, steps, batches, g, kernels, card, profile, want,
              label=None, select_impl="auto", gather_impl="auto"):
    from facl_tpu_torch.train import Trainer
    G, B, N = batches.shape[1:4]
    label = label or impl
    tr = Trainer(_cfg(B, impl, select_impl, gather_impl), steps_per_epoch=100,
                 device=dev)
    state = tr.init_state(SEED)
    state, _ = tr.run_epoch(state, [batches[0], batches[1]], epoch=0,
                            generator=g)
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    # Step boundaries are CUDA events recorded between steps, so timing
    # adds no synchronisation: each step's time is the distance between
    # the device reaching one boundary and the next.
    losses = []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    t0 = time.perf_counter()
    ev[0].record()
    for i in range(steps):
        state, m = tr.step_fn(state, batches[i % 2], generator=g)
        ev[i + 1].record()
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    launches = {k.__name__: k.launches for k in kernels}
    losses = [float(v) for v in losses]
    check(all(math.isfinite(v) for v in losses),
          f"{impl}: non-finite loss {losses}")
    for name, n in launches.items():
        check(n == want.get(name, 0) * steps,
              f"{label}: kernel {name} launched {n} times in {steps} steps, "
              f"expected {want.get(name, 0) * steps}")
    per = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(steps))
    ms = statistics.median(per)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"main path {label} (sa_impl={impl}, select_impl={select_impl}, "
          f"gather_impl={gather_impl}) on {card}: B={B} G={G} N={N} f32, "
          f"{steps} steps: median {ms:.2f} ms/step (min {per[0]:.2f}, "
          f"quartiles {per[steps // 4]:.2f}-{per[3 * steps // 4]:.2f}, max "
          f"{per[-1]:.2f}; wall-clock mean {wall:.2f}), {B / ms * 1e3:.1f} "
          f"clips/s at the median, peak {peak:.2f} GiB; losses first "
          f"{losses[0]:.4f} last {losses[-1]:.4f}; launches "
          f"{ {n: c for n, c in launches.items() if c} }", flush=True)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            s.record()
            state, m = tr.step_fn(state, batches[0], generator=g)
            e.record()
            torch.cuda.synchronize()
        span = s.elapsed_time(e)
        ka = p.key_averages()
        table = ka.table(sort_by="self_cuda_time_total", row_limit=25)
        busy = sum(x.self_device_time_total for x in p.events()
                   if x.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        print(f"profile of one {label} step: device busy {busy:.2f} ms (sum "
              f"of kernel times) over the step's own span of {span:.2f} ms "
              f"(CUDA events; the profiler's host overhead lengthens it): "
              f"idle share {max(0.0, 1 - busy / span):.3f}\n" + table,
              flush=True)
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of the parent commit: its sa_pair.cu "
                         "is built and its B2b, B3a, B3b and B3c timed "
                         "against this tree's in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the "
             "port on a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import facl_tpu_torch  # noqa: F401  (sets TF32 off)
    from facl_tpu_torch.ops import _build

    dev = torch.device("cuda")
    name_power = gpu_name_power()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name_power}", flush=True)
    parent = start_parent_build(args.parent) if args.parent else None
    t_build = _build.build_all()
    print(f"build: {t_build:.1f} s for {len(_build.SOURCES)} sources "
          "(parallel nvcc)", flush=True)
    for src, log in _build.REGISTRY.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {src}: {line.strip()}", flush=True)
    if parent:
        load_parent(parent)

    from facl_tpu_torch.train import Trainer
    model = Trainer(_cfg(64), 100, device=dev).init_state(SEED).model
    g = torch.Generator().manual_seed(SEED)
    points = torch.randn(10, 64, 512, 4, generator=g).to(dev)
    rows = phase_kernels(dev, model, points)
    del model, points
    torch.cuda.empty_cache()
    phase_cpu_vs_card(dev)
    paths = phase_main(dev, args.profile, name_power)
    paths.update(phase_input_grad(dev))

    # Each kernel's launches: from the first path (in the order run) that
    # runs it — B1-B3 on pair3, B6 on pair, B7 and B8 on hybrid2, B9 on
    # pallas, B4 and B5a on its split routes, B5b on the input gradient.
    launches = {}
    for counts in paths.values():
        for name, n in counts.items():
            if n:
                launches.setdefault(name, n)
    out = []
    for r in rows:
        out.append({"name": r["name"], "route": "cuda", "source": r["source"],
                    "replaces": r["replaces"],
                    "launches": launches[r["fn"].__name__],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "host_us": r["host_us"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    **{k: r[k] for k in ("bound_f32_ms", "parent_ab")
                       if k in r},
                    "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": out}))
    print(gpu_name_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
