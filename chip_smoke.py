#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of facl_tpu on one NVIDIA GPU and hold
every hand-written kernel against its plain PyTorch twin.

    python3 chip_smoke.py             # needs one CUDA device
    python3 chip_smoke.py --profile   # + a torch.profiler breakdown of
                                      #   one main-path step
    python3 chip_smoke.py --parent DIR  # + B1, B2a, B2b, B3a, B3b, B3c
                                        #   and the f32 B7 of the tree in
                                        #   DIR (a git archive of another
                                        #   commit) timed against this
                                        #   tree's, in turns, their
                                        #   outputs bit-equal; the f32
                                        #   B6, B8a, B8b and B9 alike,
                                        #   within phase 2's f32 bars of
                                        #   the parent's
                                        #   (sweep2_vs_parent, cnt1
                                        #   exact; two_sweep_vs_parent,
                                        #   b9_vs_parent); the bf16 B2a-B3c,
                                        #   B6, B8a, B8b and B9 within
                                        #   phase 2's bf16 bars (B9's at its
                                        #   own bars, b9_bf16_vs_parent),
                                        #   each at its wrapper's grid; and
                                        #   the pair and hybrid2 f32 steps
                                        #   with the parent's f32 B6 and
                                        #   B8b, in turns (with --profile,
                                        #   three profiled steps of each
                                        #   turn)

Phases (any failure exits nonzero, before the final line):
  1. build   every kernel from facl_tpu_torch/ops/csrc (one nvcc per
             source, in parallel) and print the build time and ptxas use;
  2. kernels each kernel and its twin on the same card tensors at the
             main path's shapes (64 videos x 10 crops x 512 points, S=K=64,
             SA widths 4-64-64-256): B1, B4 and B5a bit-equal (B4's idx
             also to B1's); B5b within 1e-5 of the scale of index_add_,
             two runs equal;
             B2/B3/B6/B7/B8 accumulators to 1e-4 of their max-abs (cnt1
             exactly); B9's eight launches (the f32 ones on the TF32
             tensor cores: stats to 1e-5, BN sums and dW to 1e-4 of
             their max-abs, db near zero; run to run bit-identical); row
             outputs, pooled
             values and B9's dx at rtol 1e-5 / atol 1e-5 x scale; pool
             indices equal except where the twin's own values tie.
             B5a and B5b again on 0.8-cube clouds (spread rows); B1
             and B4 bit-equal also on those clouds, on body-like slab
             clouds (B1's selection runs at most centroids there; never
             on randn clouds) and at the fine variant's S=32, K=128, each
             case with its share of centroids holding more than K points
             in their ball; B1 timed with idx on the randn, cube and slab
             clouds.
             Times (device_ms): CUDA events around 20 back-to-back calls
             queued behind a spin of the card, so the device time excludes
             the host's; the host's time per call beside it; beside B5a
             and B5b one library call (torch.gather, index_add_). B2a
             (tensor cores, 6xTF32), B2b, B3b, B3c, B6, B8a and B8b
             (3xTF32) print two bounds:
             the tensor-core one (bound_ms) and the f32 CUDA-core one
             (bound_f32_ms). B2a, B2b, B3a-B3c, B6, B8a and B8b are run to
             run bit-identical; B2b and B3a-B3c are checked again on the fine
             variant's K = 128. Then
             the five bf16 sweeps (B2a-B3c at compute_dtype bfloat16)
             against their bf16 twins on the same card tensors: bf16
             outputs within one bf16 ulp but at counted flips (at most
             1e-3 of the entries; the counts printed), pool indices
             outside bf16 near-ties, f32 accumulators within 1e-3 of their
             max-abs, run to run bit-identical; timed, with bounds at bf16
             bytes or the bf16 tensor-core rate per product (the five
             again at the fine variant's K = 128); B6, B7 and
             B8 at bf16 alike, their accumulators within ACC2_BAR of
             their max-abs and cnt1 exact (two_sweep_bf16_rows); B9's
             eight launches at bf16 alike (b9_bf16_rows: the bf16
             cotangent zeroed on bf16 near-tie pairs, pooled bit-equal
             outside them, accumulators within B9_BF16_BAR, dx at rtol
             1e-5 but at counted rows; the host's us per B9 launch also
             with the flat weights built once, as a stage call builds
             them). Then
             the whole SA stage (forward + backward) of each sa_impl with
             kernels (pair3, pair, hybrid2, hybrid, pallas, and each at
             bf16) at K=64 and K=128 on the same inputs as kernels, twins
             and float64 twins: the kernels must be as close to float64
             as the twins (the bf16 kernels as the bf16 twins);
  3. cpu-vs-card one full-width train step at B=8 for pair3, pair, hybrid2
             and pallas on the CPU (twins) and on the card (kernels, then
             twins), same weights, points and permutation: loss at rtol
             1e-4, BN-absorbed biases near zero; the ReLU and pool
             decisions that flipped between the devices are counted,
             gradients held at max-abs 2e-4 of their scale where no flip
             reaches and at relative L2 1e-2 everywhere (phase_cpu_vs_card
             says why); and pair3 at bf16, CPU (bf16 twins) vs card (bf16
             kernels): loss at rtol 1e-2, the card's gradients no farther
             from float64 than twice the CPU's (_cpu_vs_card_bf16); the
             same for pallas at bf16 (B9's bf16 sweeps);
  4. main    the Trainer at full width, f32, B=64 (bench.py's workload),
             sa_impl pair3 (the default; the headline): 2 warm-up steps
             (run_epoch), then 40 steps timed by CUDA events between steps
             (median and spread); then pair, hybrid2, hybrid and pallas, 2
             warm-up and 20 timed steps each, and pallas on the split
             grouping routes (select_impl=pallas / gather_impl=xla: B4;
             xla / pallas: B5a), 2 + 5 steps each; covar and analytic (no
             SA kernel) 20 each; then compute_dtype bfloat16 (the shipped
             training configs' dtype): pair3 (the bf16 sweeps) 40 steps,
             reference, pair, hybrid2, hybrid, pallas (B9 at bf16), covar
             and analytic 20 each. Losses finite and every
             kernel of each path launched exactly its count per step
             (counters zeroed just before each path, read just after).
             --profile adds one profiled step to each impl's path: kernel
             time (kernel_ms: user annotations left out) over that step's
             own span gives the device's idle share; with --parent the
             pair and hybrid2 f32 steps run again, 20 steps each in turns
             with the parent's f32 B6 / B8b and with this tree's
             (parent_step_ab, PARENT_STEPS; --profile: three profiled
             steps each);
  5. input   d(loss)/d(points) through each grouping route and the
             pallas SA stage with input_grad (B9's dx, B5b) at B=8: card
             kernels vs card twins vs CPU (phase_input_grad), with exact
             launches per route; and the bf16 pallas stage on the default
             route (B9's bf16 sweeps with dx, B1, B5b) at the bf16 bars;
  6. pipeline the user's flow through the port's CLIs, in this process,
             on a random 192-video tree written under build/ (deleted at
             the end): the native .npy loader in use, its host ms per
             64-video batch beside NumPy's, the host-to-device copy and
             the crop factory's device ms per stream; motion pretrain on
             configs/motion_ntu60_xview.json (one epoch, then --resume to
             two: index.json at epoch 1), appearance pretrain on
             configs/appearance_ntu60_xsub.json (one epoch), one step
             with --sa-impl auto (bf16 pair3: B1 and the five bf16
             sweeps once each); extract for both streams (one finite
             (5632,) file per video, B1 once per batch; motion twice,
             bit-equal); the extraction step's device ms at B=64 in f32
             and bf16, and CPU vs card on 8 videos (f32 at 1e-4 of scale
             outside counted pool-argmax flips, bf16 at 5e-2); the probe
             (50 epochs), timed (phase_pipeline).
  6b. swav   SwAV and CLD (phase_swav): the shipped SwAV config
             (configs/dual_ntu120_large_batch.json: bf16, reference,
             B=256) as it is, 2 warm-up and 5 timed steps at epoch 10 with
             a full queue (queue_on), then with use_swav off: ms/step,
             peak, B1's launches and SwAV's own cost; pair3 bf16 at B=64
             with SwAV and CLD on (the bf16 B2/B3 sweeps, 20 steps) beside
             phase 4's pair3 bf16 median; a small-width SwAV+CLD step
             (B=8, cld_clusters 4) CPU vs card: loss terms and the new
             queue at rtol 2e-4 / atol 1e-5, gradients at phase 3's bars
             (flips and k-means label flips counted; a flipped label
             touches every gradient, held then by relative L2 alone);
             the queue gate (untouched before the start epoch, shifted by B
             from it, scoring only once its last slot is set).
  6c. datagen the port's generator at NTU size (phase_datagen):
             DatagenConfig()'s defaults (424x512 frames, caps 60/30/10, a
             128x96x96 grid, S=2048) on synthetic depth clips (the port's
             numpy synthetic_depth_clip, 72 frames; no PNG is read),
             clip_batch 1 and 4: raw, key, app, n_raw and n_key bit-equal
             card vs CPU (same draws) and batch vs single; ms a clip and
             peak; group_points_level2 (B1 once, bit-equal to the CPU);
             generate --synthetic 32 on the card, then pretrain with the
             shipped SwAV config on that tree (batch 16, 11 epochs: the
             queue opens at epoch 10), its checkpoints' queues, a restore
             bit-equal, and --resume; then (6d (e)) on the same tree,
             cli.moco and pretrain with a slow_fast config (a temp
             file), one epoch each at batch 16, their launches counted
             and each checkpoint restored bit-equal.
  6d. moco/slow_fast (phase_moco_slowfast): (a) MoCo at full width, 64
             videos a view, queue 9600: auto (bf16 pair3), pair3 f32
             and the shipped motion config (bf16 reference), 3 warm-up
             and 20 timed steps each (ms/step, clips/s, peak), B1 once
             over 128 clouds and each pair3 sweep once a step at its
             dtype, nothing from the key encoder; each launch at these
             shapes against its twin at phase 2's bars; (b) MoCo pair3
             f32, CPU vs card at B=8: loss at rtol 2e-4, the queue at
             rtol 2e-4 / atol 1e-5, the pointer equal, gradients before
             Adam at phase 3's bars or at twice the CPU's own f32
             distance from a float64 step where that is larger (MoCo's
             loss saturates: its gradients carry the logits' absolute
             rounding); (c) slow/fast, 10 x 64 = 640 clouds, S=64, K=128
             and 64, f32 and bf16: ms/step and peak, B1 twice a step,
             each grouping bit-equal to its twin; (d) slow/fast f32 CPU
             vs card on 80 clouds: loss at rtol 2e-4, gradients at the
             same bars, flipped ReLU and pool decisions counted
             (_sf_touched).
  7. dp      data and tensor parallelism on the one card: ranks started by
             facl_tpu_torch.parallel.spawn, two gloo ranks sharing the card
             (NCCL takes one card a rank). (a) the pair3 and pair SA stages
             (f32 and bf16) at bench.py's batch (B=64, 32 a rank) against
             the one-process stage on the same card tensors: gradients
             equal on both ranks; f32: statistics at rtol 1e-5 / 1e-4,
             gradients at relative L2 1e-2, and at max-abs 2e-4 of their
             scale with the cotangent zeroed at the (pool, channel) groups
             whose routing flipped (_dp_stage_grads); bf16: statistics
             within 1e-3 of their max-abs, statistics and gradients no
             farther from the f32 stage than twice the one process's; per
             rank one launch of each sweep and 3 + 3 B6s all-reduces (3 +
             2 for pair), timed and counted in bytes; which collectives
             gloo takes on CUDA tensors. (b) the Trainer step, pair3 f32
             and bf16, pair bf16 and reference bf16 at B=64, against one
             process from the same weights, points and permutation: f32
             loss at rtol 2e-4, gradients before Adam at phase 3's bars
             (flips counted over the ranks' decisions in the one process's
             row order), running statistics at rtol 1e-3 / atol 1e-5; bf16
             loss at rtol 2e-3, loss and running statistics at the f32
             bars of the one process rounding as two ranks
             (tests/torch_two_halves.py: the GEMMs and BatchNorm sums
             split and summed as the ranks do, the pair stage run as two
             ranks in two threads), loss, statistics and gradients no farther
             from the f32 step than twice the one process's, and the
             witnesses printed (_dp_bf16_step); parameters bit-equal
             across the ranks after 3 steps; each collective and kernel
             counted per step. (c) the pair3 step over NCCL at world size
             1. (d) the shipped configs/multichip_ntu120.json at its width:
             sa_impl auto (bf16 pair3) at its B=512, its own reference at
             B=128 (cut: two reference ranks at 256 would need ~2 x 60
             GiB); 2 warm-up and 5 timed steps a rank, ms/step,
             collectives' host ms and bytes by kind, peak allocation a
             rank; then each run's kernels against their twins on rank
             0's inputs at the run's size (_dp_kernels: B1 bit-equal, the
             bf16 sweeps at phase 2's bars). (e) inside phase 6, on its
             tree: torchrun --nproc_per_node 2 pretrain --mesh (shipped
             motion config, one epoch) and extract --mesh, each video's
             f32 features against the one-process extract at 1e-5 of
             their scale (_dp_clis). (f) the pair3 f32 step with SwAV and
             CLD at B=64, two gloo ranks vs one process (_dp_swav): loss
             terms at rtol 2e-4, the queue bit-equal across the ranks,
             gradients before Adam at phase 3's bars, collectives counted.
             (g) MoCo pair3 at f32 and bf16 (B=64, 32 a rank) and
             slow/fast f32 (10 x 8 clouds), two gloo ranks vs one
             process (_dp_moco_slowfast): f32 loss at rtol 2e-4,
             gradients before Adam at phase 3's bars with flips
             counted; bf16 MoCo's loss and queue at the f32 bars of one
             process as two halves, loss and gradients no farther from
             the f32 step than twice one process's; the queue and
             pointer bit-equal across the ranks and, f32, within rtol
             5e-4 / atol 5e-6 of one process's; collectives counted.
             (h) tensor parallelism (mesh.mp > 1: the Denses of 512
             columns or more split by output columns over the mp ranks)
             at bench.py's workload: two gloo ranks at dp = 1 x mp = 2,
             pair3 f32 and bf16, against one process (_dp_tensor_parallel):
             f32 at (b)'s bars with flips counted; bf16 at (b)'s bf16 bars
             against one process computing each split Dense as two
             column-block GEMMs (tests/torch_two_halves.py::
             as_column_blocks), its gradients' bit-equality counted; loss,
             whole gradients, parameters and BatchNorm buffers bit-equal
             across the ranks after 2 steps; collectives counted; the
             bytes of parameters plus Adam state a rank (half of the split
             kernels and their moments saved, exactly); then 2 warm-up and
             5 timed steps a rank (ms/step, peak), and 5 more with the
             collectives' host ms and bytes by kind; then one f32 step on
             four ranks (dp = 2 x mp = 2) at (b)'s bars. (i) covar and
             analytic under dp, f32 and bf16, two gloo ranks at B=64
             against one process (_dp_covar_analytic): f32 at (b)'s bars,
             bf16 at (b)'s bf16 bars against one process as two halves
             (Gram/colsum and analytic's backward sums split as the ranks
             split them); collectives counted; 1 warm-up and 3 timed steps
             a rank.
Output: a ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import importlib.util
import io
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

# H100 SXM (NVIDIA data sheet, dense, at the 700 W limit): f32 on CUDA
# cores, TF32 and bf16 on tensor cores and HBM3 bandwidth.
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
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


def bound(nbytes: float, ops: float, tc_ops: float = 0.0, passes: int = 3,
          bf16_ops: float = 0.0, exact_ops: float = 0.0):
    """(ms, "bytes" or "operations"): the larger of bytes over the memory
    rate and the operations over their peak rates — ``ops`` f32 on CUDA
    cores, ``tc_ops`` (product flops) on tensor cores in ``passes`` TF32
    passes each (3xTF32, or B2a's 6xTF32), or with ``passes=0`` once at
    the bf16 rate (bf16 operands, f32 accumulation); ``bf16_ops``
    (product flops of bf16 operands) at the bf16 rate beside them (B9 at
    bf16: its f32-operand products in 3xTF32); ``exact_ops`` (product
    flops with one operand exact in TF32, its lo 0) in two TF32 passes
    (B6 and B8b at f32: sweep2_exact)."""
    tb = nbytes / PEAK_BYTES * 1e3
    tc = passes * tc_ops / PEAK_TF32 if passes else tc_ops / PEAK_BF16
    tc += 2 * exact_ops / PEAK_TF32
    to = (ops / PEAK_F32 + tc + bf16_ops / PEAK_BF16) * 1e3
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
    (for the yardstick chains below; the port itself never does this). B9's
    stage passes its sweeps the flat weights (``prm``), which a twin does
    not take."""
    from facl_tpu_torch.ops import sa_kernel as SK

    def twin(m, k):
        plain = getattr(m, k.__name__ + "_plain")
        if m is not SK:
            return plain
        return functools.wraps(plain)(
            lambda *a, prm=None, **kw: plain(*a, **kw))
    return swapped([(m, k.__name__, twin(m, k))
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


def b9_z(x, layers, packed, bf=False):
    """z (R, C_L) of B9's top layer, its BatchNorm output before the ReLU,
    recomputed by the twins' op chain in x's dtype from the forward's
    packed statistics (for near_ties and the routing records); with
    ``bf`` the bf16 chain's, rounded to bf16 as B9 at bf16 routes on it."""
    from facl_tpu_torch.ops import sa_kernel as SK
    r = SK._rb if bf else SK._same
    layers = [SK.SALayerParams(*(t.to(x.dtype) for t in lp)) for lp in layers]
    v = SK.vectors(layers, packed.to(x.dtype), None, x.shape[0], bf)
    h = SK._forward_plain(x, layers, v, len(layers) - 1, bf)[1][-1]
    w = layers[-1].kernel.shape[1]
    return r((r(h @ r(layers[-1].kernel)) + v[-1, 0, :w]) * v[-1, 3, :w]
             + v[-1, 4, :w])


def _z64(p2, stats, lp2, lp3, eps=1e-5):
    """z of one chain's forward, in float64 (for near_ties)."""
    from facl_tpu_torch.ops.sa_bwd import _fold_affine, _h_from_p
    mul2, shift2 = _fold_affine(lp2, *stats[1], eps)
    mul3, shift3 = _fold_affine(lp3, *stats[2], eps)
    h2 = _h_from_p(p2, mul2, shift2).double()
    return (h2 @ lp3.kernel.double() + lp3.bias.double()) * mul3.double() \
        + shift3.double()


def sa_chain_vs_f64(x3, layers, dpooled, pool, impl="pair3", dtype=None):
    """The whole SA stage of ``impl`` — forward, then the backward for a
    given pooled cotangent — three times on the same card inputs:
    kernels (f32), twins (f32) and twins in float64 (``dtype=
    torch.bfloat16``: the bf16 kernels and the bf16 twins, on x and
    dpooled rounded to bf16, which the float64 chain takes too). Every
    output (pooled, stats, gradients; not the BN-absorbed biases) must be as
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
    bf = dtype == torch.bfloat16
    if bf:          # the stage's inputs as the bf16 path sees them
        x3, dpooled = x3.to(dtype).float(), dpooled.to(dtype).float()
    low = dtype if bf else torch.float32
    rows = x3.transpose(1, 2).reshape(-1, x3.shape[1]).contiguous()

    def fwd(dt):
        # dt: float64, or float32 for the kernels' (and twins') run, which
        # stores its rows as ``low``; parameters stay f32.
        L = [SP.SALayerParams(*(t.to(dt) for t in lp)) for lp in layers]
        if pair:
            xd = x3.to(low) if dt == torch.float32 else x3.to(dt)
            pooled, stats, res = SP.sa_forward_pair(
                xd, L, pool, 1e-5, low if dt == torch.float32 else dt)
        elif impl == "pallas":
            pooled, stats, packed = SK.sa_train_forward_unified(
                rows.to(dt), L, pool, 1e-5,
                low if dt == torch.float32 else dt)
            res = dict(packed=packed)
        else:
            f = SF.sa_forward_4sweep if impl == "hybrid2" else SB._forward_ps
            if dt == torch.float32:
                pooled, stats, p1, p2 = f(rows.to(low), L, pool, 1e-5, low)
            else:
                pooled, stats, p1, p2 = f(rows.to(dt), L, pool, 1e-5)
            res = dict(p1=p1, p2=p2)
        outs = {"pooled": pooled}
        for i, (m, v) in enumerate(stats, 1):
            outs[f"mean{i}"], outs[f"var{i}"] = m, v
        return L, stats, res, outs

    def bwd(dt, L, stats, res, outs, route):
        if pair:
            k = dt == torch.float32
            grads = SP.sa_backward_pair(
                x3.to(low if k else dt), L, stats, dict(res, idx=route),
                dpooled.to(low if k else dt), pool, 1e-5,
                slim=impl == "pair3", dtype=low if k else dt)
        elif impl == "pallas":
            outs["dx"], grads = SK.sa_train_backward_unified(
                rows.to(dt), L, res["packed"], route.to(dt), pool, True,
                low if dt == torch.float32 else dt)
        else:
            k = dt == torch.float32
            grads = SB.sa_backward_2sweep(
                rows.to(low if k else dt), res["p1"], res["p2"], L, stats,
                route.to(low if k else dt), pool, 1e-5, low if k else dt)
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
    label = f"{impl} bf16" if bf else impl
    print(f"SA chain {label} K={pool} vs float64 ({len(ref)} outputs): worst "
          f"relative L2 kernels {wk:.2e}, twins {wt:.2e}{note}", flush=True)
    return wk, wt


SRC2 = "facl_tpu_torch/ops/csrc/sa_2sweep.cu"
#: The SA impls with kernels, in the order the main phase drives them.
IMPLS = ("pair3", "pair", "hybrid2", "hybrid")


def sweep2_err(k, t, name):
    """B6/B8b: every accumulator within 1e-4 of its max-abs, cnt1 exact.
    Returns (the largest absolute error, the widest error as a share of
    its accumulator's max-abs, that accumulator's name)."""
    check(torch.equal(k["cnt1"], t["cnt1"]), f"{name}: cnt1 not exact")
    return (max(acc_err(k[n], t[n], f"{name} {n}") for n in t),
            *sweep2_share(k, t))


def sweep2_share(k, t):
    """(the widest error of k's accumulators against t's as a share of
    its max-abs, its name); t's names."""
    return max((float((k[n] - t[n]).abs().max()) /
                max(float(t[n].abs().max()), 1e-30), n) for n in t)


def sweep2_checked(fn, args, plain, name):
    """The f32 B6/B8b (3xTF32) against its twin at phase 2's f32 bar
    (sweep2_err), and two calls bit-identical; prints the widest error as
    a share of its accumulator's max-abs (the margin under the bar).
    Returns the largest absolute error."""
    k = fn(*args)
    check(all(torch.equal(v, fn(*args)[n]) for n, v in k.items()),
          f"{name}: two runs differ")
    e, share, at = sweep2_err(k, plain(*args), name)
    print(f"{name} (3xTF32): accumulators at most {share:.3e} of their "
          f"max-abs ({at}; bar 1e-4), cnt1 exact, run to run "
          "bit-identical", flush=True)
    return e


def sweep2_ops(C0, C1=64, C2=64):
    """Operations per row of B6/B8b past h1: h2 (3 C2); dy2 (2 C2 C2 +
    3 C2); q2 (C2 + 2 C2 C1); mq (C1); A2 (2 C2 C1); G1 (symmetric, C1
    (C1 + 1)); TM1 and the C0 U1 blocks ((C0 + 1)(2 C1 C1 + C1)); the four
    colsums (4 C1); T1x, P1 (4 C1 C0); Gx (symmetric, C0 (C0 + 1)); cx."""
    return (3 * C2 + 2 * C2 * C2 + 3 * C2 + C2 + 2 * C2 * C1 + C1
            + 2 * C2 * C1 + C1 * (C1 + 1) + (C0 + 1) * (2 * C1 * C1 + C1)
            + 4 * C1 + 4 * C1 * C0 + C0 * (C0 + 1) + C0)


def sweep2_tc(C0, C1=64, C2=64):
    """The products of sweep2_ops, per row: h2 M3, q2, A2, G1 (symmetric)
    and TM1 with the C0 U1 blocks."""
    return (2 * C2 * C2 + 2 * C2 * C1 + 2 * C2 * C1 + C1 * (C1 + 1)
            + (C0 + 1) * 2 * C1 * C1)


def sweep2_n8(C0, C1=64):
    """The operations of sweep2_ops that the bf16 kernel computes as
    products of its n8 tile [x | 1] on the tensor cores: T1x, P1 (4 C1
    C0); the four colsums (4 C1); Gx (symmetric, C0 (C0 + 1)); cx."""
    return 4 * C1 * C0 + 4 * C1 + C0 * (C0 + 1) + C0


def sweep2_exact(C0, C1=64):
    """The part of sweep2_tc + sweep2_n8 with one operand exact in TF32,
    which 3xTF32 runs in two passes: the products of m1 (0 or 1), TM1 (2
    C1 C1) and T1x (2 C1 C0), and those of the ones column, the four
    colsums (4 C1) and cx (C0)."""
    return 2 * C1 * C1 + 2 * C1 * C0 + 4 * C1 + C0


def b8a_ops(C2=64, C3=256, bf=False):
    """B8a's work per row: (CUDA-core operations, tensor-core product
    flops). Products, all dense: h2 W3 (2 C2 C3), Gram(h2) (symmetric,
    C2 (C2 + 1)), A3 = dy3^T h2 (2 C3 C2) and q3 = D W3^T (2 C3 C2). On
    CUDA cores: h2 (3 C2: affine, ReLU), colsum(h2) (C2), z's affine (3
    C3), the route (3 C3: the group's max, the ties, dy3), u3 (C3), D =
    gi3 dy3 (C3); at bf16 also the roundings of p3, the share and D
    (C3)."""
    tc = 2 * C2 * C3 + C2 * (C2 + 1) + 2 * C3 * C2 + 2 * C3 * C2
    return 4 * C2 + (10 if bf else 9) * C3, tc


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

    def add(name, args, err, nbytes, ops, fn, replaces, tc_ops=0,
            exact_ops=0):
        rows.append(dict(name=name, args=args, err=err, nbytes=nbytes,
                         ops=ops, tc_ops=tc_ops, exact_ops=exact_ops, fn=fn,
                         plain=getattr(SF if fn in SF.KERNELS else SB,
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
    check(all(torch.equal(a, b) for a, b in zip(k, SB.sa_bwd2_sweep1(*as1))),
          "B8a: two runs differ")
    ops, tc = b8a_ops(C2, C3)
    # Products dense on the tensor cores (3xTF32), the rest on CUDA cores.
    add("sa_bwd2_sweep1", as1,
        max(acc_err(k[0], A3, "B8a A3"), acc_err(k[1], u3, "B8a u3"),
            acc_err(k[2], G2b, "B8a G2"), acc_err(k[3], ch2b, "B8a ch2"),
            row_err(k[4], q3, "B8a q3")),
        2 * R * C2 * 4 + P * C3 * 4, R * ops, SB.sa_bwd2_sweep1,
        "facl_tpu/ops/pallas/sa_bwd.py:275", R * tc)
    print(f"B8a: dpooled zeroed on {int(near.sum())} of {near.numel()} "
          f"near-tie (group, channel) pairs; {nnz} nonzero dy3 entries "
          f"({nnz / max(int((dp != 0).sum()), 1):.2f} rows per routed pair); "
          "run to run bit-identical", flush=True)
    t3 = _layer_terms(A3, u3, lp3, m3, v3, G2b, ch2b, R, eps)
    as2 = (xr, p1, mul1, shift1, p2, mul2, shift2, q3, t3["M"].contiguous(),
           t3["rc"], gi2, lp2.kernel)
    # Products (and the n8 tile's, sweep2_n8) on the tensor cores in
    # 3xTF32, those with an exact operand (sweep2_exact) in two passes,
    # the rest on CUDA cores.
    tc2 = sweep2_tc(C0) + sweep2_n8(C0, C1)
    ex2 = sweep2_exact(C0, C1)
    add("sa_bwd2_sweep2", as2,
        sweep2_checked(SB.sa_bwd2_sweep2, as2, SB.sa_bwd2_sweep2_plain,
                       "B8b"),
        R * (C0 + 3 * C1) * 4, R * (3 * C1 + sweep2_ops(C0) - tc2),
        SB.sa_bwd2_sweep2, "facl_tpu/ops/pallas/sa_bwd.py:298",
        R * (tc2 - ex2), R * ex2)
    return rows


def slab_clouds(B: int, N: int, C: int, g) -> torch.Tensor:
    """(B, N, C) body-like clouds: xyz uniform in +-0.2 x +-0.5 x +-0.05
    (a depth crop normalised by its y extent, as facl_tpu's
    normalize_xyz does), the other channels randn. At r^2 = 0.06 almost
    every centroid holds more than 64 points in its ball, so B1's
    selection runs there; on randn clouds it never does."""
    xyz = (torch.rand(B, N, 3, generator=g) * 2 - 1) * torch.tensor(
        [0.2, 0.5, 0.05])
    return torch.cat([xyz, torch.randn(B, N, C - 3, generator=g)], 2)


def over_k_share(pts, S: int, K: int, r2: float) -> float:
    """The share of centroids with more than K points in their ball."""
    from facl_tpu_torch.ops.select import sqdist_to_centroids
    return float(((sqdist_to_centroids(pts, S) <= r2).sum(-1) > K)
                 .float().mean())


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


def b9_ops(widths, C0, sweep, target=-1, split=False):
    """f32 operations per row of one B9 launch, from the TPU kernel's own
    recomputes: a layer costs 2 cin w for its product and 4 w for bias,
    affine and ReLU; stats sweeps 4 w more for the sums; the pool 1 per
    top element, its cotangent split 3; the backward per layer 8 w for
    mask, xhat and dp (6 w for the target's sums), 2 cin w for da = dp
    W^T below the top, and in the final sweep 2 cin w + w for dW and db
    and the dx product. With ``split``, the same operations as (products
    of bf16 operands at compute_dtype bfloat16: the forward products and
    da; products with an f32 operand: dW and dx; the rest); with ``split=
    "tf32"`` as (the f32 kernel's tensor-core product flops: the forward
    products of layers >= 1, da and dW; the rest, layer 0's product and dx
    among them, on CUDA cores)."""
    cins = [C0] + list(widths[:-1])
    L = len(widths)
    bf = f32 = rest = 0

    def layer(l):
        return 2 * cins[l] * widths[l], 4 * widths[l]
    n = target if sweep == "stats" else L
    for l in range(n):
        prod, other = layer(l)
        bf, rest = bf + prod, rest + other
    if sweep == "stats":
        prod, other = layer(target)
        bf, rest = bf + prod, rest + other        # its bias and sums
    elif sweep == "pool":
        rest += widths[-1]
    else:
        rest += 3 * widths[-1]
        stop = target if sweep == "bnsum" else -1
        for l in range(L - 1, stop, -1):
            rest += 8 * widths[l]
            if l:
                bf += 2 * cins[l] * widths[l]          # da
            elif sweep == "final":
                f32 += 2 * cins[l] * widths[l]         # dx
            if sweep == "final":
                f32 += 2 * cins[l] * widths[l]         # dW
                rest += widths[l]                      # db
        if sweep == "bnsum":
            rest += 6 * widths[target]
    if split == "tf32":
        l0 = 2 * C0 * widths[0]
        dx = l0 if sweep == "final" else 0
        return bf - l0 + f32 - dx, rest + l0 + dx
    return (bf, f32, rest) if split else bf + f32 + rest


def b9_rows(xr, layers, K, dpooled):
    """B9's eight launches of a main-path step (three stats sweeps, the
    pool sweep, three BN-sum sweeps, the final sweep) against their twins
    on the same card tensors, each fed its twin's inputs: sums and dW to
    1e-4 of their max-abs (stats to 1e-5), pooled and dx at rtol 1e-5 /
    atol 1e-5 x scale, db (exactly zero: a BatchNorm follows each Dense)
    near zero; each run to run bit-identical. dpooled is zero on the
    near_ties pairs of a float64 recompute (tolerance 1e-5 of the largest
    |z|), where a kernel and a twin that sum in another order may route
    differently. The main path's net runs the TF32 tensor-core kernel
    (f32_on_tensor_cores): bounds with its products in 3xTF32 (b9_ops
    split "tf32"), the f32 CUDA-core bound beside them."""
    from facl_tpu_torch.ops import sa_kernel as SK
    from facl_tpu_torch.ops.sa_fwd import _finalize
    R, C0 = xr.shape
    widths = [lp.kernel.shape[1] for lp in layers]
    L, P, eps = len(layers), R // K, 1e-5
    rows = []
    tc = SK.f32_on_tensor_cores(R, C0, widths, K)
    check(tc, f"B9 f32 at widths {widths}, pool {K}: not on the tensor "
              "cores")

    def same(fn, args, out, name):
        check(all(torch.equal(a, b) for a, b in
                  zip(_outputs(out), _outputs(fn(*args)))),
              f"B9 {name}: two runs differ")

    def add(name, args, err, nbytes, ops, fn):
        sweep = fn.__name__.split("_")[2]
        target = int(name.split("layer ")[1][0]) if "layer " in name else -1
        tc_ops, cuda = b9_ops(widths, C0, sweep, target, split="tf32")
        rows.append(dict(name=name, args=args, err=err, nbytes=nbytes,
                         ops=R * cuda, tc_ops=R * tc_ops, passes=3, fn=fn,
                         plain=getattr(SK, fn.__name__ + "_plain"),
                         source=SRC9,
                         replaces="facl_tpu/ops/pallas/sa_kernel.py:282"
                         if fn in (SK.sa_fused_stats, SK.sa_fused_pool) else
                         "facl_tpu/ops/pallas/sa_kernel.py:480"))

    packed = torch.zeros(L, 2, max(widths), device=xr.device)
    for l, w in enumerate(widths):
        a = (xr, layers, packed.clone(), K, l)
        k, t = SK.sa_fused_stats(*a), SK.sa_fused_stats_plain(*a)
        same(SK.sa_fused_stats, a, k, f"stats {l}")
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
    k = SK.sa_fused_pool(*a)
    same(SK.sa_fused_pool, a, k, "pool")
    add("sa_fused_pool", a, row_err(k, SK.sa_fused_pool_plain(*a),
                                    "B9 pooled"),
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
        same(SK.sa_fused_bnsum, a, k, f"bnsum {l}")
        add(f"sa_fused_bnsum (layer {l})", a,
            max(acc_err(k[0], t[0], f"B9 bnsum {l} sum dy"),
                acc_err(k[1], t[1], f"B9 bnsum {l} sum dy xhat")),
            R * C0 * 4 + P * widths[-1] * 4,
            b9_ops(widths, C0, "bnsum", l), SK.sa_fused_bnsum)
        bsums[l, 0, :widths[l]], bsums[l, 1, :widths[l]] = t
    a = (xr, layers, packed, bsums, dp, K, True)
    (kd, kw, kb), (td, tw, tb) = SK.sa_fused_final(*a), \
        SK.sa_fused_final_plain(*a)
    same(SK.sa_fused_final, a, (kd, kw, kb), "final")
    err = max([row_err(kd, td, "B9 dx")] +
              [acc_err(kk, tt, f"B9 dW{l}") for l, (kk, tt) in
               enumerate(zip(kw, tw))])
    gscale = max(float(t.abs().max()) for t in tw)
    for l, (kk, tt) in enumerate(zip(kb, tb)):
        check(max(float(kk.abs().max()), float(tt.abs().max())) <
              1e-4 * gscale, f"B9 db{l} (exactly zero) not near zero")
    add("sa_fused_final", a, err, 2 * R * C0 * 4 + P * widths[-1] * 4,
        b9_ops(widths, C0, "final"), SK.sa_fused_final)
    print(f"B9 (TF32 tensor cores): dpooled zeroed on {int(near.sum())} of "
          f"{near.numel()} near-tie (group, channel) pairs; every sweep "
          "within its bars, run to run bit-identical", flush=True)
    return rows


def b9_bf16_near_ties(xr, layers, packed, K):
    """(P, C_L) bool: the (group, channel) pairs whose bf16 pool routing
    sits one rounding from a switch, on the twin's bf16 top activations
    (b9_z): a distinct value within one bf16 ulp below the group's max, a
    positive max within one ulp of zero, or a dead group with a y within
    one ulp of zero. A product whose f32 sum lies at a bf16 rounding
    midpoint rounds the other way in a kernel that sums in another order,
    and moves its row by an ulp."""
    z = b9_z(xr, layers, packed, True)
    zg = z.reshape(-1, K, z.shape[1])
    h = torch.relu(zg)
    m = h.amax(1, keepdim=True)
    u = bf16_ulp(m)
    return (((m - h) > 0) & ((m - h) <= u)).any(1) | \
        ((m[:, 0] > 0) & (m[:, 0] <= u[:, 0])) | \
        ((m[:, 0] == 0) & (zg > -u).any(1))


#: b9_bf16_rows' bar for an f32 accumulator of B9 at bf16 against its
#: twin, as a share of the twin's max-abs. Each sweep recomputes every
#: layer from x, so a product that the kernel rounds to the other bf16
#: neighbour (its f32 sum at a rounding midpoint) moves its row's values
#: downstream, with or without the near-tie pairs' cotangent zeroed: on
#: an NVIDIA H100 80GB HBM3 at 700 W this script reads 7.35e-5 (layer 0's
#: BN sum of dy xhat), above ACC2_BAR's 3e-5 for sweeps fed stored rows.
B9_BF16_BAR = 3e-4


def b9_bf16_rows(xr, layers, K, dpooled):
    """B9's eight launches at bf16 (sa_fused_*_bf16) against their bf16
    twins on the same card tensors, each fed its twin's inputs: the main
    path's grouped rows (f32, rounded at load), the model's SA weights, a
    bf16 cotangent zeroed on the bf16 near-tie pairs (b9_bf16_near_ties).
    Bars: stats sums, BN sums and dW within B9_BF16_BAR of their max-abs
    and db (exactly zero) within it of dW's; pooled bit-equal outside the
    near-tie pairs and within one bf16 ulp at counted flips (bf16_flips)
    inside; dx at rtol 1e-5 / atol 1e-5 x scale on all but at most 1e-3
    of its rows (counted: rows that a rounding the other way upstream
    moved) and within 1e-2 x scale on those; run to run bit-identical.
    Bounds: bytes as the f32 sweeps' (x, dout, pooled and dx stay f32);
    the forward products and da = dp W^T at the bf16 tensor-core rate, dW
    and dx (an f32 operand) in 3xTF32, the rest on f32 CUDA cores; the
    f32 CUDA-core bound beside it."""
    from facl_tpu_torch.ops import sa_kernel as SK
    from facl_tpu_torch.ops.sa_fwd import _finalize
    R, C0 = xr.shape
    widths = [lp.kernel.shape[1] for lp in layers]
    L, P, eps = len(layers), R // K, 1e-5
    rows, rel = [], []

    def acc(k, t, name):
        err = acc_rel(k, t, f"B9 bf16 {name}", B9_BF16_BAR)
        rel.append((err / max(float(t.abs().max()), 1e-30), name))
        return err

    def flat(o):
        if isinstance(o, (list, tuple)):
            return [u for t in o for u in flat(t)]
        return [o]

    def same(fn, args, out, name):
        check(all(torch.equal(a, b) for a, b in
                  zip(flat(out), flat(fn(*args)))),
              f"B9 bf16 {name}: two runs differ")

    def add(name, fn, args, err, nbytes, sweep, target=-1):
        bf, f32, rest = b9_ops(widths, C0, sweep, target, split=True)
        rows.append(dict(name=name, args=args, err=err, nbytes=nbytes,
                         ops=R * rest, tc_ops=R * f32, bf16_ops=R * bf,
                         passes=3, fn=fn,
                         plain=getattr(SK, fn.__name__ + "_plain"),
                         source=SRC9,
                         replaces="facl_tpu/ops/pallas/sa_kernel.py:282"
                         if sweep in ("stats", "pool") else
                         "facl_tpu/ops/pallas/sa_kernel.py:480"))

    packed = torch.zeros(L, 2, max(widths), device=xr.device)
    for l, w in enumerate(widths):
        a = (xr, layers, packed.clone(), K, l)
        k, t = SK.sa_fused_stats_bf16(*a), SK.sa_fused_stats_bf16_plain(*a)
        same(SK.sa_fused_stats_bf16, a, k, f"stats {l}")
        e = max(acc(k[0], t[0], f"stats {l} sum p"),
                acc(k[1], t[1], f"stats {l} sum p^2"))
        add(f"sa_fused_stats (layer {l}) [bf16]", SK.sa_fused_stats_bf16, a,
            e, R * C0 * 4, "stats", l)
        mean, var = _finalize(t[0], t[1], R)
        packed[l, 0, :w], packed[l, 1, :w] = mean, torch.rsqrt(var + eps)
    near = b9_bf16_near_ties(xr, layers, packed, K)
    a = (xr, layers, packed, K)
    k, t = SK.sa_fused_pool_bf16(*a), SK.sa_fused_pool_bf16_plain(*a)
    same(SK.sa_fused_pool_bf16, a, k, "pool")
    check(torch.equal(k[~near], t[~near]),
          "B9 bf16 pooled differs outside the near-tie pairs")
    npool, e = bf16_flips(k, t, "B9 bf16 pooled")
    add("sa_fused_pool [bf16]", SK.sa_fused_pool_bf16, a, e,
        R * C0 * 4 + P * widths[-1] * 4, "pool")

    dp = torch.where(near, 0.0, dpooled.to(BF16).float())
    bsums = torch.zeros_like(packed)
    for l in reversed(range(L)):
        a = (xr, layers, packed, bsums.clone(), dp, K, l)
        k, t = SK.sa_fused_bnsum_bf16(*a), SK.sa_fused_bnsum_bf16_plain(*a)
        same(SK.sa_fused_bnsum_bf16, a, k, f"bnsum {l}")
        e = max(acc(k[0], t[0], f"bnsum {l} sum dy"),
                acc(k[1], t[1], f"bnsum {l} sum dy xhat"))
        add(f"sa_fused_bnsum (layer {l}) [bf16]", SK.sa_fused_bnsum_bf16, a,
            e, R * C0 * 4 + P * widths[-1] * 4, "bnsum", l)
        bsums[l, 0, :widths[l]], bsums[l, 1, :widths[l]] = t
    a = (xr, layers, packed, bsums, dp, K, True)
    (kd, kw, kb), (td, tw, tb) = SK.sa_fused_final_bf16(*a), \
        SK.sa_fused_final_bf16_plain(*a)
    same(SK.sa_fused_final_bf16, a, (kd, kw, kb), "final")
    scale = float(td.abs().max())
    diff = (kd - td).abs()
    beyond = (diff > 1e-5 * td.abs() + 1e-5 * scale).any(1)
    nb, wide = int(beyond.sum()), float(diff.max()) / scale
    check(nb <= 1e-3 * R and wide <= 1e-2,
          f"B9 bf16 dx: {nb} of {R} rows beyond rtol 1e-5 / atol 1e-5 x "
          f"scale (bar 1e-3 of the rows), widest {wide:.3e} x scale")
    e = max([float(diff.max())] + [acc(kk, tt, f"dW{l}") for l, (kk, tt) in
                                   enumerate(zip(kw, tw))])
    gscale = max(float(t_.abs().max()) for t_ in tw)
    for l, (kk, tt) in enumerate(zip(kb, tb)):
        check(max(float(kk.abs().max()), float(tt.abs().max())) <
              B9_BF16_BAR * gscale,
              f"B9 bf16 db{l} (exactly zero) not near zero")
    add("sa_fused_final [bf16]", SK.sa_fused_final_bf16, a, e,
        2 * R * C0 * 4 + P * widths[-1] * 4, "final")
    worst = max(rel)
    print(f"B9 bf16 vs its bf16 twins (R={R}, K={K}): dpooled zeroed on "
          f"{int(near.sum())} of {near.numel()} bf16 near-tie pairs, pooled "
          f"bit-equal outside them ({npool} entries beyond one bf16 ulp "
          f"inside); dx: {nb} rows beyond rtol 1e-5 / atol 1e-5 x scale, "
          f"widest {wide:.3e} x scale; db at most "
          f"{max(float(t_.abs().max()) for t_ in kb) / gscale:.3e} of dW's "
          f"max-abs; accumulators at most {worst[0]:.3e} of their max-abs "
          f"({worst[1]}; bar {B9_BF16_BAR:g}); all eight run to run "
          "bit-identical", flush=True)
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


BF16 = torch.bfloat16


def bf16_ulp(v):
    """One bf16 ulp at |v| (f32 tensor of bf16 values): 2^(e - 8) for |v|
    in [2^(e - 1), 2^e); at zero the smallest normal's."""
    _, e = torch.frexp(v.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v), e - 8)


def bf16_flips(k, t, name, bar=1e-3):
    """A bf16 row output against its twin: every entry within one bf16 ulp
    of the twin's (the larger of the two values' ulps), except where a
    bf16 rounding or ReLU decision upstream went the other way between
    the two summation orders: those entries are counted, and held to at
    most ``bar`` of the entries. Returns (entries beyond one ulp, max |k -
    t|)."""
    a, b = k.float(), t.float()
    d = (a - b).abs()
    n = int((d > bf16_ulp(torch.maximum(a.abs(), b.abs()))).sum())
    check(n <= bar * a.numel(), f"{name}: {n} of {a.numel()} entries beyond "
                                f"one bf16 ulp of the twin (bar {bar:g})")
    return n, float(d.max())


def bf16_index_flips(k_idx, t_idx, t_vals, name):
    """Pool indices equal but where the twin's f32 value at the kernel's
    index is within one bf16 ulp of its f32 value at its own index (a
    near-tie that the two summation orders break apart: one bf16
    rounding of a row's product the other way). Both sides unrounded: the
    bf16 best the sweep stores sits up to half an ulp off the f32 one.
    Returns (differing indices, their widest gap in ulps of the f32 best,
    the same gap from the stored bf16 best)."""
    bad = k_idx != t_idx
    if not bool(bad.any()):
        return 0, 0.0, 0.0
    g, c = bad.nonzero(as_tuple=True)
    v = t_vals[g, k_idx[g, c].long(), c]
    best = t_vals[g, t_idx[g, c].long(), c]
    ulp = bf16_ulp(best.abs())
    gap = (v - best).abs() / ulp
    check(bool((gap <= 1).all()), f"{name}: {int((gap > 1).sum())} pool "
                                  "indices differ beyond a bf16 near-tie")
    stored = (v - best.to(BF16).float()).abs() / ulp
    return int(bad.sum()), float(gap.max()), float(stored.max())


def gram_pool_bf16_p3(p2, mul2, shift2, w3, b3, pool):
    """B2b-bf16's p3 = bf16(h2 bf16(W3)) + bf16(b3) in f32, as its twin
    forms it, grouped (P, pool, C3): the values bf16_index_flips reads."""
    SP = sweep_modules()[0]
    h2 = SP._h2_bf16(p2, mul2, shift2)
    p3 = SP._rb(h2 @ SP._rb(w3)) + SP._rb(b3)
    return p3.reshape(-1, pool, w3.shape[1])


def bf16_vs_parent(name, mine, theirs, p3=None):
    """A bf16 sweep's outputs (``_outputs`` order) against the parent
    tree's at phase 2's bf16 bars: bf16 rows within one bf16 ulp but at
    counted flips (bf16_flips), pool indices equal but at bf16 near-ties
    of the twin's f32 p3 (bf16_index_flips; ``p3`` from
    gram_pool_bf16_p3), f32 accumulators within 1e-3 of the parent's
    max-abs (acc_rel). Fails otherwise. Returns a note of the counts."""
    check(len(mine) == len(theirs), f"--parent: {name} returns "
                                    f"{len(mine)} tensors, the parent "
                                    f"{len(theirs)}")
    notes = []
    for i, (a, b) in enumerate(zip(mine, theirs)):
        what = f"--parent: {name} output {i}"
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{what}: {a.dtype} {tuple(a.shape)} against the parent's "
              f"{b.dtype} {tuple(b.shape)}")
        if a.dtype == BF16:
            notes.append(f"{i}: {bf16_flips(a, b, what)[0]} beyond one ulp")
        elif a.dtype == torch.int32:
            check(p3 is not None, f"{what}: pool indices need p3")
            notes.append(f"{i}: {bf16_index_flips(a, b, p3, what)[0]} "
                         "indices at near-ties")
        else:
            acc_rel(a, b, what)
    return "; ".join(notes)


def acc_rel(k, t, name, bar=1e-3):
    """An f32 accumulator of a bf16 sweep: within ``bar`` of its max-abs."""
    err = float((k - t).abs().max())
    scale = float(t.abs().max())
    check(err <= bar * max(scale, 1e-30),
          f"{name}: accumulator error {err:.3e} > {bar:g} x {scale:.3e}")
    return err


def bf16_rows(x3, layers, dpooled, K):
    """The five bf16 sweeps (B2a, B2b, B3a, B3b, B3c at bf16) against
    their bf16 twins on the same card tensors, each fed the twin chain's
    inputs: the main path's grouped x rounded to bf16, the model's SA
    weights, dpooled as a bf16 cotangent. Bars: bf16 outputs within one
    bf16 ulp outside counted flips (bf16_flips: at most 1e-3 of the
    entries), pool indices outside bf16 near-ties (bf16_index_flips), f32
    accumulators within 1e-3 of their max-abs (acc_rel); run to run
    bit-identical. Returns the kernel-table rows."""
    SP = sweep_modules()[0]
    from facl_tpu_torch.ops.sa_bwd import _fold_affine, _layer_terms
    from facl_tpu_torch.ops.sa_fwd import _finalize
    lp1, lp2, lp3 = layers
    Bc, C0, N = x3.shape
    R, P, eps = Bc * N, Bc * N // K, 1e-5
    C1, C2, C3 = 64, 64, 256
    xb = x3.to(BF16).contiguous()
    dpb = dpooled.to(BF16).contiguous()
    xf = xb.float()
    rows, notes = [], []
    m1, v1 = SP._moments_from_gram(torch.einsum("bcn,bdn->cd", xf, xf),
                                   xf.sum((0, 2)), lp1.kernel, lp1.bias, R)
    mul1, shift1 = _fold_affine(lp1, m1, v1, eps)

    def same(fn, args, out, name):
        check(all(torch.equal(a, b) for a, b in zip(out, fn(*args))),
              f"{name}: two runs differ")

    def add(name, fn, args, err, nbytes, ops, tc_ops, replaces):
        rows.append(dict(name=name, args=args, err=err, nbytes=nbytes,
                         ops=ops, tc_ops=tc_ops, passes=0, fn=fn,
                         plain=getattr(SP, fn.__name__ + "_plain"),
                         replaces=replaces))

    a12 = (xb, lp1.kernel, lp1.bias, mul1, shift1, lp2.kernel, lp2.bias)
    p2, s2, ss2 = SP.sa_fwd_layer12_bf16_plain(*a12)
    k = SP.sa_fwd_layer12_bf16(*a12)
    same(SP.sa_fwd_layer12_bf16, a12, k, "layer12 bf16")
    n, e = bf16_flips(k[0], p2, "layer12 bf16 p2")
    e = max(e, acc_rel(k[1], s2, "layer12 bf16 s"),
            acc_rel(k[2], ss2, "layer12 bf16 ss"))
    notes.append(f"B2a p2 {n}")
    add("sa_fwd_layer12 [bf16]", SP.sa_fwd_layer12_bf16, a12, e,
        R * (C0 + C2) * 2, R * (2 * C0 * C1 + 6 * C1 + 5 * C2),
        R * 2 * C1 * C2, "facl_tpu/ops/pallas/sa_pair.py:634")

    m2, v2 = _finalize(s2, ss2, R)
    mul2, shift2 = _fold_affine(lp2, m2, v2, eps)
    agp = (p2, mul2, shift2, lp3.kernel, lp3.bias, K)
    G2, ch2, mx, mn, imx, imn = SP.sa_fwd_gram_pool_bf16_plain(*agp)
    k = SP.sa_fwd_gram_pool_bf16(*agp)
    same(SP.sa_fwd_gram_pool_bf16, agp, k, "gram_pool bf16")
    p3 = gram_pool_bf16_p3(*agp)
    nx, ex = bf16_flips(k[2], mx, "gram_pool bf16 max")
    nn, en = bf16_flips(k[3], mn, "gram_pool bf16 min")
    ix = (bf16_index_flips(k[4], imx, p3, "gram_pool bf16 argmax"),
          bf16_index_flips(k[5], imn, p3, "gram_pool bf16 argmin"))
    ni = sum(r[0] for r in ix)
    del p3
    e = max(ex, en, acc_rel(k[0], G2, "gram_pool bf16 G2"),
            acc_rel(k[1], ch2, "gram_pool bf16 ch2"))
    notes.append(f"B2b max/min {nx}/{nn}, indices {ni}" + (
        f" (widest {max(r[1] for r in ix):.3f} ulp from the twin's f32 "
        f"best, {max(r[2] for r in ix):.3f} from its stored bf16 best)"
        if ni else ""))
    add("sa_fwd_gram_pool [bf16]", SP.sa_fwd_gram_pool_bf16, agp, e,
        R * C2 * 2 + P * C3 * (2 + 2 + 4 + 4),
        R * (4 * C2 + 4 * C3 + 2 * C3), R * (C2 * (C2 + 1) + 2 * C2 * C3),
        "facl_tpu/ops/pallas/sa_pair.py:660")

    m3, v3 = SP._moments_from_gram(G2, ch2, lp3.kernel, lp3.bias, R)
    mul3, shift3 = _fold_affine(lp3, m3, v3, eps)
    sel = mul3 >= 0
    zstar = torch.where(sel, mx.float(), mn.float()) * mul3 + shift3
    idx = torch.where(zstar > 0, torch.where(sel, imx, imn),
                      torch.full_like(imx, K))
    gi2 = lp2.scale * torch.rsqrt(v2 + eps)
    gi3 = lp3.scale * torch.rsqrt(v3 + eps)
    as1 = (p2, mul2, shift2, dpb, idx, gi3, lp3.kernel, K)
    A3, u3, q3 = SP.sa_bwd_sweep1_bf16_plain(*as1)
    k = SP.sa_bwd_sweep1_bf16(*as1)
    same(SP.sa_bwd_sweep1_bf16, as1, k, "sweep1 bf16")
    n, e = bf16_flips(k[2], q3, "sweep1 bf16 q3")
    e = max(e, acc_rel(k[0], A3, "sweep1 bf16 A3"),
            acc_rel(k[1], u3, "sweep1 bf16 u3"))
    notes.append(f"B3a q3 {n}")
    nnz = int((idx < K).sum())
    add("sa_bwd_sweep1 [bf16]", SP.sa_bwd_sweep1_bf16, as1, e,
        2 * R * C2 * 2 + P * C3 * (2 + 4), nnz * (4 * C2 + 3) + R * 4 * C2,
        0, "facl_tpu/ops/pallas/sa_pair.py:772")
    # The kernel takes q3 as the TPU kernel's dense product (R x C3 x C2 on
    # tensor cores): work its design chooses, not the function's, so the
    # bound stays the sparse count; the dense product's ideal time beside.
    rows[-1]["dense_ms"] = R * C3 * C2 * 2 / PEAK_BF16 * 1e3

    t3 = _layer_terms(A3, u3, lp3, m3, v3, G2, ch2, R, eps)
    as2 = (xb, lp1.kernel, lp1.bias, mul1, shift1, p2, mul2, shift2, q3,
           t3["M"].contiguous(), t3["rc"], gi2, lp2.kernel)
    A2, G1, u2, ch1, mq = SP.sa_bwd_sweep2_bf16_plain(*as2)
    k = SP.sa_bwd_sweep2_bf16(*as2)
    same(SP.sa_bwd_sweep2_bf16, as2, k, "sweep2 bf16")
    n, e = bf16_flips(k[4], mq, "sweep2 bf16 mq")
    e = max([e] + [acc_rel(a, b, f"sweep2 bf16 {nm}") for a, b, nm in
                   zip(k[:4], (A2, G1, u2, ch1), ("A2", "G1", "u2", "ch1"))])
    notes.append(f"B3b mq {n}")
    add("sa_bwd_sweep2 [bf16]", SP.sa_bwd_sweep2_bf16, as2, e,
        R * (C0 + 2 * C2 + C1) * 2,
        R * (2 * C0 * C1 + 6 * C1 + 4 * C2 + 6 * C2 + 3 * C1 + C2),
        R * (2 * C2 * C2 + 2 * C2 * C1 + 2 * C2 * C1 + C1 * (C1 + 1)),
        "facl_tpu/ops/pallas/sa_pair.py:800")

    t2 = _layer_terms(A2, u2, lp2, m2, v2, G1, ch1, R, eps)
    as3 = (xb, lp1.kernel, lp1.bias, mul1, shift1, mq, t2["M"].contiguous(),
           t2["rc"])
    A1, u1 = SP.sa_bwd_sweep3_bf16_plain(*as3)
    k = SP.sa_bwd_sweep3_bf16(*as3)
    same(SP.sa_bwd_sweep3_bf16, as3, k, "sweep3 bf16")
    e = max(acc_rel(k[0], A1, "sweep3 bf16 A1"),
            acc_rel(k[1], u1, "sweep3 bf16 u1"))
    add("sa_bwd_sweep3 [bf16]", SP.sa_bwd_sweep3_bf16, as3, e,
        R * (C0 + C1) * 2, R * (2 * C0 * C1 + 6 * C1 + 4 * C1),
        R * (2 * C1 * C1 + 2 * C1 * (C0 + 1)),
        "facl_tpu/ops/pallas/sa_pair.py:835")
    print(f"bf16 sweeps vs their bf16 twins (R={R}, K={K}): entries beyond "
          f"one bf16 ulp: {'; '.join(notes)}; all five run to run "
          "bit-identical", flush=True)
    return rows


#: two_sweep_bf16_rows' bar for an f32 or float64 accumulator of a bf16
#: sweep against its twin, as a share of the twin's max-abs.
ACC2_BAR = 3e-5


def two_sweep_bf16_rows(x3, layers, dpooled, K):
    """B7 (both call shapes of B7a, B7b, B7c), B8 (B8a, B8b) and B6 at bf16
    against their bf16 twins on the same card tensors, each fed the twin
    chain's inputs: hybrid2's bf16 forward of the main path's grouped x
    rounded to bf16, and a bf16 cotangent. B8a routes inside the kernel:
    its dpooled is zero on the near_ties pairs of the twin's f32 z
    (tolerance 1e-5 of the largest |z|). B6 runs on B8b's inputs, x
    channel-major. Bars: bf16 outputs within one bf16 ulp outside counted
    flips (bf16_flips, as bf16_rows); f32 and float64 accumulators within
    ACC2_BAR of their max-abs (kernel and twin sum the same exact bf16
    products in f32; only the order of the sums differs), the widest
    reading printed;
    cnt1 of B8b and of B6 exact (B6's h1, recomputed from x, gives the
    same layer-1 masks as the bf16 forward's chain, _h1_bf16); run to run
    bit-identical. Bounds: bf16 rows' bytes, the 64-deep products (and,
    for B6 and B8b, the products of their n8 tile [x | 1], sweep2_n8) at
    the bf16 tensor-core rate, the rest (and the C0-deep x W1) on f32
    CUDA cores. Returns the kernel-table rows."""
    SP, SF, SB = sweep_modules()
    from facl_tpu_torch.ops.sa_bwd import _fold_affine, _layer_terms
    lp1, lp2, lp3 = layers
    Bc, C0, N = x3.shape
    R, P, eps = Bc * N, Bc * N // K, 1e-5
    C1, C2, C3 = 64, 64, 256
    xb = x3.to(BF16).contiguous()
    xr = xb.transpose(1, 2).reshape(R, C0).contiguous()
    rows, notes, rel = [], [], []

    def acc(k, t, name):
        err = acc_rel(k, t, name, ACC2_BAR)
        rel.append((err / max(float(t.abs().max()), 1e-30), name))
        return err

    def twin(fn):
        return getattr(sys.modules[fn.__module__], fn.__name__ + "_plain")

    def run(fn, args, name):
        k, t = fn(*args), twin(fn)(*args)
        check(all(torch.equal(a, b) for a, b in
                  zip(_outputs(k), _outputs(fn(*args)))),
              f"{name}: two runs differ")
        return k, t

    def add(name, fn, args, err, nbytes, ops, tc_ops, replaces):
        rows.append(dict(name=name, args=args, err=err, nbytes=nbytes,
                         ops=ops, tc_ops=tc_ops, passes=0, fn=fn,
                         plain=twin(fn), source=SRC2, replaces=replaces))

    def layer_row(label, args, cin, cout, h_ops, tc):
        k, t = run(SF.sa_fwd_layer_bf16, args, f"B7a bf16 {label}")
        n, e = bf16_flips(k[0], t[0], f"B7a bf16 {label} p")
        e = max(e, acc(k[1], t[1], f"B7a bf16 {label} s"),
                acc(k[2], t[2], f"B7a bf16 {label} ss"))
        notes.append(f"B7a {label} {n}")
        add(f"sa_fwd_layer ({label}) [bf16]", SF.sa_fwd_layer_bf16, args, e,
            R * (cin + cout) * 2, R * (h_ops + 5 * cout), tc,
            "facl_tpu/ops/pallas/sa_fwd.py:189")
        return t
    p1, s1, ss1 = layer_row("x->p1", (xr, lp1.kernel, lp1.bias), C0, C1,
                            2 * C0 * C1, 0)
    m1, v1 = SF._finalize(s1, ss1, R)
    mul1, shift1 = _fold_affine(lp1, m1, v1, eps)
    p2, s2, ss2 = layer_row("p1->p2", (p1, lp2.kernel, lp2.bias, mul1,
                                       shift1), C1, C2, 4 * C1,
                            R * 2 * C1 * C2)
    m2, v2 = SF._finalize(s2, ss2, R)
    mul2, shift2 = _fold_affine(lp2, m2, v2, eps)

    ag = (p2, mul2, shift2)
    k, (G2, ch2) = run(SF.sa_fwd_gram_bf16, ag, "B7b bf16")
    e = max(acc(k[0], G2, "B7b bf16 G2"),
            acc(k[1], ch2, "B7b bf16 ch2"))
    add("sa_fwd_gram [bf16]", SF.sa_fwd_gram_bf16, ag, e, R * C2 * 2,
        R * 5 * C2, R * C2 * (C2 + 1), "facl_tpu/ops/pallas/sa_fwd.py:219")
    m3, v3 = SF._moments_from_gram(G2, ch2, lp3.kernel, lp3.bias, R)
    mul3, shift3 = _fold_affine(lp3, m3, v3, eps)
    ap = (p2, mul2, shift2, lp3.kernel, lp3.bias, mul3, shift3, K)
    k, t = run(SF.sa_fwd_pool_bf16, ap, "B7c bf16")
    n, e = bf16_flips(k, t, "B7c bf16 pooled")
    notes.append(f"B7c pooled {n}")
    add("sa_fwd_pool [bf16]", SF.sa_fwd_pool_bf16, ap, e,
        R * C2 * 2 + P * C3 * 2, R * (4 * C2 + 6 * C3), R * 2 * C2 * C3,
        "facl_tpu/ops/pallas/sa_fwd.py:242")

    z = SB._z_bf16(SB._h_bf16(p2, mul2, shift2), lp3.kernel, lp3.bias, mul3,
                   shift3)
    near = near_ties(z, K, 1e-5 * float(z.abs().max()))
    dp = torch.where(near, 0.0, dpooled.float()).to(BF16)
    nnz = int((SB._dy_top(z, dp.float(), K) != 0).sum())
    del z
    gi2 = lp2.scale * torch.rsqrt(v2 + eps)
    gi3 = lp3.scale * torch.rsqrt(v3 + eps)
    as1 = (p2, mul2, shift2, lp3.kernel, lp3.bias, mul3, shift3, gi3, dp, K)
    k, (A3, u3, G2b, ch2b, q3) = run(SB.sa_bwd2_sweep1_bf16, as1, "B8a bf16")
    n, e = bf16_flips(k[4], q3, "B8a bf16 q3")
    e = max([e] + [acc(a, b, f"B8a bf16 {nm}") for a, b, nm in
                   zip(k[:4], (A3, u3, G2b, ch2b), ("A3", "u3", "G2", "ch2"))])
    notes.append(f"B8a q3 {n} (dpooled zeroed on {int(near.sum())} near-tie "
                 f"pairs; {nnz} nonzero dy3)")
    ops, tc = b8a_ops(C2, C3, bf=True)
    add("sa_bwd2_sweep1 [bf16]", SB.sa_bwd2_sweep1_bf16, as1, e,
        2 * R * C2 * 2 + P * C3 * 2, R * ops, R * tc,
        "facl_tpu/ops/pallas/sa_bwd.py:275")

    t3 = _layer_terms(A3, u3, lp3, m3, v3, G2b, ch2b, R, eps)
    as2 = (xr, p1, mul1, shift1, p2, mul2, shift2, q3, t3["M"].contiguous(),
           t3["rc"], gi2, lp2.kernel)
    tc2 = sweep2_tc(C0) + sweep2_n8(C0, C1)
    k, t = run(SB.sa_bwd2_sweep2_bf16, as2, "B8b bf16")
    check(torch.equal(k["cnt1"], t["cnt1"]), "B8b bf16: cnt1 not exact")
    e = max(acc(k[n], t[n], f"B8b bf16 {n}") for n in t)
    add("sa_bwd2_sweep2 [bf16]", SB.sa_bwd2_sweep2_bf16, as2, e,
        R * (C0 + 3 * C1) * 2, R * (4 * C1 + 3 * C2 + sweep2_ops(C0) - tc2),
        R * tc2, "facl_tpu/ops/pallas/sa_bwd.py:298")
    a6 = (xb, lp1.kernel, lp1.bias, mul1, shift1, p2, mul2, shift2, q3,
          t3["M"].contiguous(), t3["rc"], gi2, lp2.kernel)
    k, t = run(SP.sa_bwd_sweep2_full_bf16, a6, "B6 bf16")
    check(torch.equal(k["cnt1"], t["cnt1"]), "B6 bf16: cnt1 not exact")
    e = max(acc(k[n], t[n], f"B6 bf16 {n}") for n in t)
    add("sa_bwd_sweep2_full [bf16]", SP.sa_bwd_sweep2_full_bf16, a6, e,
        R * (C0 + 2 * C2) * 2,
        R * (2 * C0 * C1 + 5 * C1 + 3 * C2 + sweep2_ops(C0) - tc2), R * tc2,
        "facl_tpu/ops/pallas/sa_pair.py:863")
    worst = max(rel)
    print(f"bf16 B6/B7/B8 vs their bf16 twins (R={R}, K={K}): entries beyond "
          f"one bf16 ulp: {'; '.join(notes)}; accumulators at most "
          f"{worst[0]:.3e} of their max-abs ({worst[1]}; bar {ACC2_BAR:g}); "
          "cnt1 of B8b and B6 exact; all run to run bit-identical",
          flush=True)
    return rows


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
        check(torch.equal(SEL.select_knn_ball(pts, S, K, radius), ti),
              f"B4 {name}: idx differ from the twin")
        print(f"B1 select_gather [{name}] {tuple(pts.shape)} S={S} K={K}: "
              f"bit-equal, B4 too; {over_k_share(pts, S, K, radius):.3f} of "
              f"the centroids hold more than K={K} points in their ball",
              flush=True)
        return kg

    def b1_row(pts):
        """B1 as every path calls it (_SelectGather: with idx)."""
        return dict(name="select_gather", args=(pts, S, K, r2, True),
                    err=0.0, nbytes=Bc * N * C * 4 + Bc * C * S * K * 4
                    + Bc * S * K * 4, ops=Bc * S * N * 12,
                    fn=SEL.select_gather,
                    plain=lambda p, s, k, r, _: SEL.select_gather_plain(
                        p, s, k, r), source=SRC_SEL,
                    replaces="facl_tpu/ops/pallas/select.py:302")

    b1_case("random", flat, r2)
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    half = torch.rand(flat.shape[0], N // 2, C, generator=g) - 0.5
    b1_case("duplicates", torch.cat([half, half], 1).to(dev), 0.2)
    far = torch.randn(flat.shape, generator=g) * 10.0
    b1_case("all-out-of-radius", far.to(dev), 1e-6)
    Bc = flat.shape[0]
    rows.append(b1_row(flat))
    rows += grouping_rows(flat, S, K, r2, g)
    # B5 again on spread rows: phase_input_grad's clouds (xyz uniform in a
    # 0.8 cube) at the main path's Bc, from a generator of their own so
    # that the draws of g below stay as they were.
    gc = torch.Generator().manual_seed(SEED + 5)
    cube = torch.cat([torch.rand(Bc, N, 3, generator=gc) * 0.8 - 0.4,
                      torch.randn(Bc, N, 1, generator=gc)], 2).to(dev)
    cube_rows = b5_rows(cube, SEL.select_knn_ball(cube, S, K, r2).reshape(
        Bc, S * K), gc, "0.8 cube")
    # B1 on the same cube and on body-like slab clouds (their own
    # generator), where the selection runs at most centroids.
    b1_case("0.8 cube", cube, r2)
    cube_rows.append(b1_row(cube))
    slab = slab_clouds(Bc, N, C, torch.Generator().manual_seed(SEED + 6)
                       ).to(dev)
    b1_case("slab", slab, r2)
    slab_rows = [b1_row(slab)]

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
        check(all(torch.equal(a, b) for a, b in
                  zip((kp2, ks, kss), SP.sa_fwd_layer12(*a12))),
              "layer12: two runs differ")
        # h1, + b2 and the sums on CUDA cores; h1 W2 on tensor cores
        # (6xTF32: six TF32 passes).
        rows.append(dict(name="sa_fwd_layer12", args=a12, err=e,
                         nbytes=R * (C0 + C2) * 4,
                         ops=R * (2 * C0 * C1 + 4 * C1 + 4 * C2),
                         tc_ops=R * 2 * C1 * C2, passes=6,
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
        # B6: sweep 2 of the pair (non-slim) backward, on B3b's inputs;
        # its products (and its n8 tile's) on tensor cores (3xTF32; those
        # with an exact operand in two passes).
        e = sweep2_checked(SP.sa_bwd_sweep2_full, as2,
                           SP.sa_bwd_sweep2_full_plain, "B6")
        tc2 = sweep2_tc(C0) + sweep2_n8(C0, C1)
        ex2 = sweep2_exact(C0, C1)
        rows.append(dict(name="sa_bwd_sweep2_full", args=as2, err=e,
                         nbytes=R * (C0 + 2 * C2) * 4,
                         ops=R * (2 * C0 * C1 + C1 + sweep2_ops(C0) - tc2),
                         tc_ops=R * (tc2 - ex2), exact_ops=R * ex2,
                         fn=SP.sa_bwd_sweep2_full,
                         plain=SP.sa_bwd_sweep2_full_plain, source=SRC2,
                         replaces="facl_tpu/ops/pallas/sa_pair.py:863"))
        rows += bf16_rows(x3, (lp1, lp2, lp3), dpooled, K)
        rows += two_sweep_rows(x3, (lp1, lp2, lp3), dpooled, K)
        rows += two_sweep_bf16_rows(x3, (lp1, lp2, lp3), dpooled, K)
        xr = x3.transpose(1, 2).reshape(R, C0).contiguous()
        rows += b9_rows(xr, [lp1, lp2, lp3], K, dpooled)
        rows += b9_bf16_rows(xr, [lp1, lp2, lp3], K, dpooled)
        del xr
        torch.cuda.synchronize()
        for impl in IMPLS + ("pallas",):
            sa_chain_vs_f64(x3, [lp1, lp2, lp3], dpooled, K, impl)
        for impl in IMPLS + ("pallas",):
            sa_chain_vs_f64(x3, [lp1, lp2, lp3], dpooled, K, impl, BF16)

        # The fine variant's grouping (S=32, K=128): B1, and pool groups
        # that span two of the sweeps' 64-row tiles.
        Sf, Kf = 32, 128
        gf = b1_case("fine", flat, r2, Sf, Kf)
        gf[:, :3] -= flat[:, :Sf, :3].transpose(1, 2)[..., None]
        dpf = torch.randn(Bc * Sf, C3, generator=g).to(dev)
        check_b2b_b3(gf.reshape(Bc, C, Sf * Kf), [lp1, lp2, lp3], Kf, dpf,
                     "fine")
        bf16_rows(gf.reshape(Bc, C, Sf * Kf), [lp1, lp2, lp3], dpf, Kf)
        for impl in IMPLS + ("pallas",):
            sa_chain_vs_f64(gf.reshape(Bc, C, Sf * Kf), [lp1, lp2, lp3], dpf,
                            Kf, impl)
        for impl in IMPLS + ("pallas",):
            sa_chain_vs_f64(gf.reshape(Bc, C, Sf * Kf), [lp1, lp2, lp3], dpf,
                            Kf, impl, BF16)

        for r in rows + cube_rows + slab_rows:
            measure(r)
    for r in rows:
        print_row(r)
    for r in cube_rows:
        print_row(r, " [0.8 cube]")
    for r in slab_rows:
        print_row(r, " [slab]")
    return rows


def measure(r):
    """Time one row's kernel, twin and library call (device_ms) and set
    its bound from the row's bytes and operations."""
    args, fn, plain = r.pop("args"), r["fn"], r.pop("plain")
    r["ms"], r["host_us"] = device_ms(lambda: fn(*args))
    if r.get("source") == SRC9:        # B9: prm built once a stage call
        prm = sa_modules()[-1]._prm(args[1], fn.__name__.endswith("_bf16"))
        r["host_prm_us"] = device_ms(lambda: fn(*args, prm=prm))[1]
    r["plain_ms"] = device_ms(lambda: plain(*args))[0]
    lib = r.pop("library", None)
    r["library_ms"] = device_ms(lib)[0] if lib else None
    nbytes, ops, tc = r.pop("nbytes"), r.pop("ops"), r.pop("tc_ops", 0)
    bf, ex = r.pop("bf16_ops", 0), r.pop("exact_ops", 0)
    r["passes"] = r.pop("passes", 3)
    r["bound_ms"], r["bound_by"] = bound(nbytes, ops, tc, r["passes"], bf,
                                         ex)
    if tc or bf:
        r["bound_f32_ms"] = bound(nbytes, ops + tc + bf + ex)[0]
    r["rate"] = f"{r['passes']}xTF32" if r["passes"] and tc else "bf16"
    if tc and bf:
        r["rate"] = f"bf16 (bf16 operands) and {r['rate']} (an f32 operand)"
    if PARENT and fn.__name__ in PARENT_AB:
        r["parent_ab"] = parent_ab(fn, args)
    r["max_abs_err"] = r.pop("err")
    r.setdefault("source", "facl_tpu_torch/ops/csrc/sa_pair.cu")


#: B9's four wrappers (sa_kernel.py), the f32 names.
B9_NAMES = ("sa_fused_stats", "sa_fused_pool", "sa_fused_bnsum",
            "sa_fused_final")
#: --parent: the parent tree's kernel libraries, and the kernels whose
#: launchers are timed against this tree's (wrapper -> (library, launcher
#: name, the blocks per SM the parent's wrapper launches it with; None
#: for a launcher that takes no grid)).
PARENT = {}
PARENT_AB = {"select_gather": ("select", "facl_select_gather", None),
             "sa_fwd_layer12": ("sa_pair", "facl_sa_fwd_layer12", 1),
             "sa_fwd_gram_pool": ("sa_pair", "facl_sa_fwd_gram_pool", 1),
             "sa_bwd_sweep1": ("sa_pair", "facl_sa_bwd_sweep1", 1),
             "sa_bwd_sweep2": ("sa_pair", "facl_sa_bwd_sweep2", 1),
             "sa_bwd_sweep3": ("sa_pair", "facl_sa_bwd_sweep3", 1),
             **{f"sa_{n}_bf16": ("sa_pair", f"facl_sa_{n}_bf16", 1) for n in
                ("fwd_layer12", "fwd_gram_pool", "bwd_sweep1", "bwd_sweep2",
                 "bwd_sweep3")},
             "sa_fwd_layer": ("sa_2sweep", "facl_sa_fwd_layer", None),
             "sa_fwd_gram": ("sa_2sweep", "facl_sa_fwd_gram", None),
             "sa_fwd_pool": ("sa_2sweep", "facl_sa_fwd_pool", None),
             "sa_bwd2_sweep1": ("sa_2sweep", "facl_sa_bwd2_sweep1", 1),
             "sa_bwd2_sweep1_bf16": ("sa_2sweep", "facl_sa_bwd2_sweep1_bf16",
                                     1),
             "sa_bwd2_sweep2": ("sa_2sweep", "facl_sa_bwd2_sweep2", 2),
             "sa_bwd_sweep2_full": ("sa_2sweep", "facl_sa_bwd2_sweep2", 2),
             "sa_bwd2_sweep2_bf16": ("sa_2sweep", "facl_sa_bwd2_sweep2_bf16",
                                     1),
             "sa_bwd_sweep2_full_bf16": ("sa_2sweep",
                                         "facl_sa_bwd2_sweep2_bf16", 1),
             **{n: ("sa_fused", "facl_sa_fused", 1) for n in
                B9_NAMES},
             **{f"{n}_bf16": ("sa_fused", "facl_sa_fused_bf16", 1) for n in
                B9_NAMES}}
PARENT_LIBS = ("select", "sa_pair", "sa_2sweep", "sa_fused")


def start_parent_build(root: str, names=PARENT_LIBS):
    """Start nvcc on ``root``'s sources of ``names`` (by default
    select.cu, sa_pair.cu, sa_2sweep.cu and sa_fused.cu; ``root`` a
    checkout of the parent commit) with this tree's flags; returns
    {library: (process, output)}."""
    from facl_tpu_torch.ops import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        src = os.path.join(root, "facl_tpu_torch", "ops", "csrc",
                           f"{name}.cu")
        check(os.path.exists(src), f"--parent: no {src}")
        out = _build.BUILD_DIR / f"parent-{name}.so"
        started[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    return started


def load_parent(started) -> None:
    import ctypes
    for name, (proc, out) in started.items():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"--parent: nvcc failed:\n{log}")
        lib = ctypes.CDLL(str(out))
        lib.facl_error_string.argtypes = [ctypes.c_int]
        lib.facl_error_string.restype = ctypes.c_char_p
        PARENT[name] = lib
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas parent {name}: {line.strip()}", flush=True)


def parent_ab(fn, args):
    """Device ms of wrapper ``fn`` on ``args`` with the parent tree's
    launcher (at the parent's grid for it, where it takes one) and with
    this tree's, in turns: parent, this tree, this tree, parent; and the
    outputs of one call of each, which must be bit-equal (fails
    otherwise), or for a bf16 sweep (a wrapper named *_bf16) within
    phase 2's bf16 bars of the parent's (bf16_vs_parent, B9's
    b9_bf16_vs_parent: the redesigned kernels sum in another order), or
    for B9 at f32 within phase 2's f32 B9 bars (b9_vs_parent: the TF32
    kernel sums in another order), or for B8a at f32 within phase 2's f32
    bars (two_sweep_vs_parent: the TF32 kernel sums in another order), or
    for B6 and B8b at f32 within phase 2's f32 bar, cnt1 exact
    (sweep2_vs_parent: the TF32 kernel sums in another order than the
    parent's CUDA-core one). The
    parent's launcher runs at its own wrapper's grid (parent_grid_swaps).
    The launchers' C signatures are the
    same in both trees (pointers are void* to ctypes). (B6 and B8b return
    dicts, B7c one tensor: their values are compared.)"""
    import ctypes
    from facl_tpu_torch.ops import _build
    lib_name, launcher, parent_per_sm = PARENT_AB[fn.__name__]
    key = (lib_name, launcher)
    ours = _build._FUNCTIONS[key]          # resolved by the timed calls
    lib = PARENT[lib_name]
    pfn = getattr(lib, launcher)
    pfn.argtypes, pfn.restype = ours[1].argtypes, ctypes.c_int

    def run_parent(out=None):
        _build._FUNCTIONS[key] = (lib, pfn)
        try:
            with swapped(parent_grid_swaps(lib_name, parent_per_sm)):
                if out is not None:
                    out.append(fn(*args))
                return device_ms(lambda: fn(*args))[0]
        finally:
            _build._FUNCTIONS[key] = ours

    def run_ours():
        return device_ms(lambda: fn(*args))[0]
    theirs = []
    ab = [run_parent(theirs), run_ours(), run_ours(), run_parent()]
    if fn.__name__ in F32_SWEEP2:
        print(f"  --parent {fn.__name__} against the parent's: "
              f"{sweep2_vs_parent(fn.__name__, fn(*args), theirs[0])}",
              flush=True)
        return ab
    mine = _outputs(fn(*args))
    theirs = [t for o in theirs for t in _outputs(o)]
    if lib_name == "sa_fused":
        vs = b9_bf16_vs_parent if fn.__name__.endswith("_bf16") else \
            b9_vs_parent
        print(f"  --parent {fn.__name__} against the parent's: "
              f"{vs(fn.__name__, mine, theirs)}", flush=True)
        return ab
    if fn.__name__.endswith("_bf16"):
        p3 = gram_pool_bf16_p3(*args) if "gram_pool" in fn.__name__ \
            else None
        print(f"  --parent {fn.__name__} against the parent's: "
              f"{bf16_vs_parent(fn.__name__, mine, theirs, p3)}", flush=True)
        return ab
    if fn.__name__ == "sa_bwd2_sweep1":
        print(f"  --parent {fn.__name__} against the parent's: "
              f"{two_sweep_vs_parent(fn.__name__, mine, theirs)}", flush=True)
        return ab
    check(len(mine) == len(theirs) and
          all(torch.equal(a, b) for a, b in zip(mine, theirs)),
          f"--parent: {fn.__name__}'s outputs differ from the parent's")
    return ab


def parent_grid_swaps(lib_name: str, blocks):
    """The (module, name, value) swaps that launch a parent launcher at the
    grid its own wrapper gave it: sa_pair's and sa_bwd's ``grid`` at
    ``blocks`` blocks an SM (the parent's f32 B6 and B8b ran two 256-thread
    blocks an SM where this tree's TF32 kernel runs one of 512; its B8a at
    either dtype and its bf16 B6 and B8b one of 512, as this tree's);
    B9's ``_nblk`` at ``blocks`` blocks an SM (one 512-thread block an SM
    at either dtype, as this tree's); none for a launcher that takes no
    grid (blocks None)."""
    from facl_tpu_torch.ops import _build
    from facl_tpu_torch.ops import sa_bwd as SB
    from facl_tpu_torch.ops import sa_kernel as SK
    from facl_tpu_torch.ops import sa_pair as SP
    if not blocks:
        return []
    if lib_name == "sa_fused":
        def nblk(x, widths, pool, bf):
            R = x.shape[0]
            tiles = -(-(R // pool) // ((64 if pool <= 64 else 128) // pool))
            return max(1, min(tiles, blocks * _build.sm_count(x.device)))
        return [(SK, "_nblk", nblk)]

    def grid(t, R, per_sm=2):
        return min(R // 64, blocks * _build.sm_count(t.device))
    return [({"sa_pair": SP, "sa_2sweep": SB}[lib_name], "grid", grid)]


def b9_bf16_vs_parent(name, mine, theirs):
    """A bf16 B9 sweep's outputs (``_outputs`` order) against the parent
    tree's at phase 2's B9 bf16 bars (b9_bf16_rows): the pooled bf16
    values within one bf16 ulp but at counted flips (bf16_flips), f32
    accumulators (sums, dW) within B9_BF16_BAR of the parent's max-abs,
    db (exactly zero: a BatchNorm follows each Dense) within it of the
    parent's dW max-abs on both sides, dx (R, C0) at rtol 1e-5 / atol
    1e-5 x scale on all but 1e-3 of its rows (counted). Fails otherwise;
    returns a note of the counts."""
    check(len(mine) == len(theirs), f"--parent: {name} returns "
                                    f"{len(mine)} tensors, the parent "
                                    f"{len(theirs)}")
    final = "final" in name
    L = (len(theirs) - 1) // 2                  # dx, [dW_l], [db_l]
    gscale = max(float(t.abs().max()) for t in theirs[1:1 + L]) \
        if final else 0.0
    notes = []
    for i, (a, b) in enumerate(zip(mine, theirs)):
        what = f"--parent: {name} output {i}"
        check(a.shape == b.shape, f"{what}: {tuple(a.shape)} against the "
                                  f"parent's {tuple(b.shape)}")
        if "pool" in name:
            notes.append(f"pooled: {bf16_flips(a, b, what)[0]} beyond one "
                         "ulp")
        elif final and i > L:
            check(max(float(a.abs().max()), float(b.abs().max())) <
                  B9_BF16_BAR * gscale, f"{what}: db (exactly zero) not "
                                        "near zero")
        elif final and i == 0:
            scale = float(b.abs().max())
            beyond = ((a - b).abs() > 1e-5 * b.abs() + 1e-5 * scale).any(1)
            nb = int(beyond.sum())
            check(nb <= 1e-3 * a.shape[0], f"{what}: {nb} of {a.shape[0]} dx "
                                           "rows beyond rtol 1e-5 / atol "
                                           "1e-5 x scale")
            notes.append(f"dx: {nb} rows beyond")
        else:
            acc_rel(a, b, what, B9_BF16_BAR)
    return "; ".join(notes) or "sums within B9_BF16_BAR"


def b9_vs_parent(name, mine, theirs):
    """An f32 B9 sweep's outputs (``_outputs`` order) against the parent
    tree's at phase 2's f32 B9 bars (b9_rows): a stats sweep's sums within
    1e-5 of the parent's max-abs; BN sums and dW within 1e-4; pooled and
    dx at rtol 1e-5 / atol 1e-5 x scale; db (exactly zero: a BatchNorm
    follows each Dense) within 1e-4 of the parent's dW max-abs on both
    sides. Fails otherwise; returns a note of the largest errors."""
    check(len(mine) == len(theirs), f"--parent: {name} returns "
                                    f"{len(mine)} tensors, the parent "
                                    f"{len(theirs)}")
    final = "final" in name
    L = (len(theirs) - 1) // 2                  # dx, [dW_l], [db_l]
    gscale = max(float(t.abs().max()) for t in theirs[1:1 + L]) \
        if final else 0.0
    worst = 0.0
    for i, (a, b) in enumerate(zip(mine, theirs)):
        what = f"--parent: {name} output {i}"
        check(a.shape == b.shape, f"{what}: {tuple(a.shape)} against the "
                                  f"parent's {tuple(b.shape)}")
        scale = max(float(b.abs().max()), 1e-30)
        if "pool" in name or (final and i == 0):
            row_err(a, b, what)
        elif final and i > L:
            check(max(float(a.abs().max()), float(b.abs().max())) <
                  1e-4 * gscale, f"{what}: db (exactly zero) not near zero")
            continue
        else:
            bar = 1e-5 if "stats" in name else 1e-4
            err = float((a - b).abs().max())
            check(err <= bar * scale, f"{what}: {err:.3e} beyond {bar:g} x "
                                      f"{scale:.3e}")
        worst = max(worst, float((a - b).abs().max()) / scale)
    return f"within phase 2's f32 bars, largest |this - parent| " \
        f"{worst:.3e} of the parent's max-abs"


#: The f32 B8b and B6 wrappers (one TF32 kernel, sa_2sweep.cu).
F32_SWEEP2 = ("sa_bwd2_sweep2", "sa_bwd_sweep2_full")


def sweep2_vs_parent(name, mine, theirs):
    """The f32 B8b's or B6's accumulators (dicts by name) against the
    parent tree's at phase 2's f32 bar (sweep2_err: every accumulator
    within 1e-4 of the parent's max-abs, cnt1 exact): the TF32 kernel sums
    in another order than the parent's. Fails otherwise; returns a note of
    the largest error."""
    check(set(mine) == set(theirs), f"--parent: {name} returns "
                                    f"{sorted(mine)}, the parent "
                                    f"{sorted(theirs)}")
    _, share, at = sweep2_err(mine, theirs, f"--parent: {name}")
    return f"within phase 2's f32 bar, cnt1 exact, largest |this - " \
        f"parent| {share:.3e} of the parent's max-abs ({at})"


def two_sweep_vs_parent(name, mine, theirs):
    """The f32 B8a's outputs (``_outputs`` order: A3, u3, G2, ch2, q3)
    against the parent tree's at phase 2's f32 bars (two_sweep_rows): its
    tensor-core sums run in another order than the parent's CUDA-core
    kernel. Accumulators within 1e-4 of the parent's max-abs (acc_err), the
    row output q3 at rtol 1e-5 / atol 1e-5 x scale (row_err). Fails
    otherwise; returns a note of the largest errors."""
    check(len(mine) == len(theirs), f"--parent: {name} returns "
                                    f"{len(mine)} tensors, the parent "
                                    f"{len(theirs)}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(mine, theirs)):
        what = f"--parent: {name} output {i}"
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{what}: {a.dtype} {tuple(a.shape)} against the parent's "
              f"{b.dtype} {tuple(b.shape)}")
        scale = max(float(b.abs().max()), 1e-30)
        if i == 4:
            row_err(a, b, what)
        else:
            acc_err(a, b, what)
        worst = max(worst, float((a - b).abs().max()) / scale)
    return f"within phase 2's f32 bars, largest |this - parent| " \
        f"{worst:.3e} of the parent's max-abs"


def _outputs(out):
    """A wrapper's tensors: a dict's values, one tensor, or a tuple (its
    lists flattened, a None left out: B9's final sweep)."""
    if isinstance(out, dict):
        return list(out.values())
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out if o is not None for t in _outputs(o)]


def print_row(r, label=""):
    lib = "" if r["library_ms"] is None else \
        f", library {r['library_ms']:.4f} ms"
    tc = "" if "bound_f32_ms" not in r else \
        f" with products on tensor cores in {r['rate']} (f32 " \
        f"CUDA-core bound {r['bound_f32_ms']:.4f} ms)"
    dense = "" if "dense_ms" not in r else \
        f"; its dense q3 product alone {r['dense_ms']:.4f} ms at the bf16 " \
        "tensor-core rate"
    prm = "" if "host_prm_us" not in r else \
        f" ({r['host_prm_us']:.1f} us with its flat weights built once a " \
        "stage call, as sa_train_*_unified call it)"
    print(f"kernel {r['name']}{label}: {r['ms']:.4f} ms on the device, "
          f"{r['host_us']:.1f} us on the host per call{prm} (twin "
          f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
          f"{r['bound_by']}{tc}{lib}{dense}), max |kernel - twin| = "
          f"{r['max_abs_err']:.3e}", flush=True)
    if "parent_ab" in r:
        ab = r["parent_ab"]
        print(f"  A/B {r['name']} in turns (parent, this tree, this tree, "
              f"parent): {' / '.join(f'{v:.4f}' for v in ab)} ms on the "
              f"device; parent mean {(ab[0] + ab[3]) / 2:.4f}, this tree "
              f"{(ab[1] + ab[2]) / 2:.4f}; outputs "
              + ("within phase 2's bf16 bars of" if
                 r["fn"].__name__.endswith("_bf16") else
                 "within phase 2's f32 B9 bars of" if
                 r["source"] == SRC9 else
                 "within phase 2's f32 bars of" if
                 r["fn"].__name__ in ("sa_bwd2_sweep1",) + F32_SWEEP2 else
                 "bit-equal to")
              + " the parent's", flush=True)


def _cfg(batch, impl="pair3", select_impl="auto", gather_impl="auto",
         dtype="float32"):
    import dataclasses
    from facl_tpu_torch.config import Config
    cfg = Config()
    return cfg.replace(train=dataclasses.replace(cfg.train, batch_size=batch),
                       model=dataclasses.replace(cfg.model, sa_impl=impl,
                                                 compute_dtype=dtype),
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
            _, (_, lp2, lp3), pool, eps = args[:4]
            mul2, shift2 = SB._fold_affine(lp2, *out[1][1], eps)
            mul3, shift3 = SB._fold_affine(lp3, *out[1][2], eps)
            if out[3].dtype == BF16:
                z = SB._z_bf16(SB._h_bf16(out[3], mul2, shift2), lp3.kernel,
                               lp3.bias, mul3, shift3)
            else:
                z = (SB._h_from_p(out[3], mul2, shift2) @ lp3.kernel +
                     lp3.bias) * mul3 + shift3
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
    if routes:                        # none for the plain reference stage
        dec["sa_route"] = routes[0]


def _step_decisions(d, B, pts, perm, impl, twins=False, dtype="float32"):
    """One step_fn on device ``d`` from the seed's weights (the SA sweeps'
    twins on the card with ``twins``). Returns the loss, the gradients and
    the step's discrete decisions (``_decisions``)."""
    from facl_tpu_torch.train import Trainer
    tr = Trainer(_cfg(B, impl, dtype=dtype), steps_per_epoch=100, device=d)
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
    for impl in IMPLS[:3] + ("pallas",):
        _cpu_vs_card_bf16(dev, impl, pts, perm)


def _cpu_vs_card_bf16(dev, impl, pts, perm):
    """The same B=8 step at compute_dtype bfloat16 with ``impl`` (pair3,
    pair, hybrid2 or pallas): the CPU (bf16 twins, torch's CPU bf16 GEMMs) against
    the card (the bf16 kernels, cuBLAS bf16 GEMMs with f32 accumulation),
    from the same weights, points and permutation, and both against the
    float64 step.
    At bf16 a flipped rounding moves a value by 2^-8 of itself, and two
    bf16 steps that sum in different orders put thousands of ReLU and
    pool decisions on different sides, so the f32 bars do not apply.
    Bars: loss at rtol 1e-2; over all gradients but the BN-absorbed
    biases together, the card's relative L2 from float64 at most twice
    the CPU's. Printed beside them: each gradient's card-vs-CPU relative
    L2 and cosine at their worst, and the flipped decisions."""
    from facl_tpu_torch.train import Trainer
    B = pts.shape[1]
    lc, gc, dc = _step_decisions("cpu", B, pts, perm, impl, dtype="bfloat16")
    lk, gk, dk = _step_decisions(dev, B, pts, perm, impl, dtype="bfloat16")
    l64, g64, _ = _f64_grads(Trainer(_cfg(B, impl), 100, device="cpu"),
                             pts, perm)
    check(math.isclose(lk, lc, rel_tol=1e-2),
          f"cpu-vs-card {impl} bf16 loss {lk} vs {lc}")
    gscale = max(float(t.abs().max()) for t in g64.values())
    absorbed = {n for n in gc if float(g64[n].abs().max()) < 1e-9 * gscale}
    live = [n for n in gc if n not in absorbed]

    def dist(g):
        num = sum(float((g[n] - g64[n]).norm()) ** 2 for n in live)
        return (num / sum(float(g64[n].norm()) ** 2 for n in live)) ** 0.5
    e_cpu, e_card = dist(gc), dist(gk)
    l2 = {n: _rel_l2(gk[n].double(), gc[n].double()) for n in live}
    cos = {n: float(gk[n].double().flatten() @ gc[n].double().flatten()
                    / max(float(gk[n].double().norm() *
                                gc[n].double().norm()), 1e-300))
           for n in live}
    wl, wc = max(l2, key=l2.get), min(cos, key=cos.get)
    flips = {n: int((dc[n] != dk[n]).sum()) for n in dc}
    print(f"cpu-vs-card {impl} bf16 B={B} step: loss cpu {lc:.6f} card "
          f"{lk:.6f} (f64 {l64:.6f}); relative L2 from float64 over "
          f"{len(live)} gradients: cpu {e_cpu:.3e}, card {e_card:.3e}; card "
          f"vs cpu worst relative L2 {l2[wl]:.3e} ({wl}), worst cosine "
          f"{cos[wc]:.6f} ({wc}); flipped decisions {flips} of "
          f"{ {n: dc[n].numel() for n in dc} }", flush=True)
    check(e_card <= 2 * e_cpu, f"cpu-vs-card {impl} bf16: card {e_card:.3e} "
                               f"from float64, cpu {e_cpu:.3e}")


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


#: B9: L = 3 stats sweeps + the pool sweep, 3 BN-sum sweeps + the final;
#: at compute_dtype bfloat16 the same of its bf16 sweeps.
B9_STEP = {"sa_fused_stats": 3, "sa_fused_pool": 1, "sa_fused_bnsum": 3,
           "sa_fused_final": 1}
B9_BF16_STEP = {f"{k}_bf16": n for k, n in B9_STEP.items()}
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
#: The bf16 pallas stage's input gradient on the default route: B9's bf16
#: sweeps (final with dx), B1 and B5b.
ROUTE_LAUNCHES_BF16 = dict(B9_BF16_STEP, select_gather=1, scatter_add_rows=1)


@contextlib.contextmanager
def b9_decisions(store: list):
    """Record every B9 forward's discrete decisions into ``store``: the
    ReLU masks of the layers below the top and the top layer's pool
    routing (relu(z) at the group's max, z > 0; at bf16 on z rounded to
    bf16), recomputed by the twins' ops from the forward's statistics on
    the same device."""
    from facl_tpu_torch.ops import sa_bwd as SB
    from facl_tpu_torch.ops import sa_kernel as SK
    fwd = SK.sa_train_forward_unified

    def capture(x, layers, pool, eps=1e-5, dtype=torch.float32):
        out = fwd(x, layers, pool, eps, dtype)
        bf = dtype == BF16
        r = SK._rb if bf else SK._same
        v = SK.vectors(layers, out[2], None, x.shape[0], bf)
        ps, _ = SK._forward_plain(x, layers, v, len(layers) - 1, bf)
        masks = [(r(p * v[l, 3, :p.shape[1]] + v[l, 4, :p.shape[1]]) > 0)
                 .cpu() for l, p in enumerate(ps)]
        z = b9_z(x, layers, out[2], bf)
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
    sums, so it reaches every entry: phase_cpu_vs_card). Then the same at
    compute_dtype bfloat16 on the default route (B9's bf16 sweeps, their
    f32 dx, B1 and B5b), card vs CPU at the bf16 stage bars (relative L2
    < 0.15, cosine > 0.99: two bf16 evaluations that sum in other orders
    flip many more decisions). Launches per route are counted with the
    counters zeroed just before the card run. Returns {route label:
    launches}."""
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
    cases = [(route, torch.float32) for route in ROUTES] + \
        [(("pallas", "pallas"), BF16)]
    for route, dtype in cases:
        bf = dtype == BF16

        def run(d, twins=False):
            stage = copy.deepcopy(stage0).to(d).train()
            stage.dtype = dtype
            p = pts.to(d, copy=True).requires_grad_(True)
            dec = []
            with contextlib.ExitStack() as stack:
                stack.enter_context(b9_decisions(dec))
                if twins:
                    stack.enter_context(twins_on_card())
                    stack.enter_context(grouping_twins_on_card())
                neigh, _ = group_points(p, S, K, 0.06, select_impl=route[0],
                                        gather_impl=route[1])
                (torch.sin(stage(neigh).float()) * w.to(d)).sum().backward()
            return p.grad.cpu(), dec[0]
        gc, dc = run("cpu")
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        gk, dk = run(dev)
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in kernels}
        want = ROUTE_LAUNCHES_BF16 if bf else ROUTE_LAUNCHES[route]
        label = f"{route[0]}/{route[1]}" + (" bf16" if bf else "")
        for name, n in launches.items():
            check(n == want.get(name, 0), f"input grad {label}: kernel {name}"
                  f" launched {n} times, expected {want.get(name, 0)}")
        gt, dt = run(dev, twins=True)
        flips = [int((a != b).sum()) for a, b in zip(dc, dk)]
        tflips = [int((a != b).sum()) for a, b in zip(dc, dt)]
        scale = max(float(gc.abs().max()), 1e-30)
        l2, free = _rel_l2(gk, gc), float((gk - gc).abs().max()) / scale
        if bf:
            cos = float(gk.double().flatten() @ gc.double().flatten()) / \
                max(float(gk.double().norm() * gc.double().norm()), 1e-300)
            print(f"input grad select={route[0]} gather={route[1]} bf16: "
                  f"|grad| max {scale:.3e}; card vs cpu relative L2 "
                  f"{l2:.3e}, cosine {cos:.6f}, flipped decisions (ReLU "
                  f"layers 1-2, pool routing) {flips}; card twins vs cpu "
                  f"{_rel_l2(gt, gc):.3e}, flips {tflips}; launches "
                  f"{ {n: c for n, c in launches.items() if c} }",
                  flush=True)
            check(l2 < 0.15 and cos > 0.99, f"input grad {label}: relative "
                                             f"L2 {l2:.3e}, cosine {cos:.6f}")
            out[f"input grad {label}"] = launches
            continue
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
        out[f"input grad {label}"] = launches
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
#: The bf16 paths (compute_dtype bfloat16): (label, sa_impl, timed steps,
#: launches per step). pair3, pair, hybrid2, hybrid and pallas run the
#: bf16 sweeps; reference, covar and analytic only B1.
BF16_PATHS = (
    ("pair3 bf16", "pair3", 40,
     {"select_gather": 1, "sa_fwd_layer12_bf16": 1,
      "sa_fwd_gram_pool_bf16": 1, "sa_bwd_sweep1_bf16": 1,
      "sa_bwd_sweep2_bf16": 1, "sa_bwd_sweep3_bf16": 1}),
    ("reference bf16", "reference", 20, {"select_gather": 1}),
    ("pair bf16", "pair", 20,
     {"select_gather": 1, "sa_fwd_layer12_bf16": 1,
      "sa_fwd_gram_pool_bf16": 1, "sa_bwd_sweep1_bf16": 1,
      "sa_bwd_sweep2_full_bf16": 1}),
    ("hybrid2 bf16", "hybrid2", 20,
     {"select_gather": 1, "sa_fwd_layer_bf16": 2, "sa_fwd_gram_bf16": 1,
      "sa_fwd_pool_bf16": 1, "sa_bwd2_sweep1_bf16": 1,
      "sa_bwd2_sweep2_bf16": 1}),
    ("hybrid bf16", "hybrid", 20,
     {"select_gather": 1, "sa_bwd2_sweep1_bf16": 1,
      "sa_bwd2_sweep2_bf16": 1}),
    ("pallas bf16", "pallas", 20, dict(B9_BF16_STEP, select_gather=1)),
    ("covar bf16", "covar", 20, {"select_gather": 1}),
    ("analytic bf16", "analytic", 20, {"select_gather": 1}),
)
#: The plain SA impls at f32 (no SA kernel; B1 groups): (sa_impl, timed
#: steps).
PLAIN_PATHS = (("covar", 20), ("analytic", 20))
BF16_LAUNCHES = {label: want for label, _, _, want in BF16_PATHS}
#: The pallas paths: (label, select_impl, gather_impl, timed steps,
#: launches per step).
PALLAS_PATHS = (
    ("pallas", "auto", "auto", 20, dict(B9_STEP, select_gather=1)),
    ("pallas B4", "pallas", "xla", 5, dict(B9_STEP, select_knn_ball=1)),
    ("pallas B5a", "xla", "pallas", 5, dict(B9_STEP, gather_rows=1)),
)


def phase_main(dev, profile: bool, card: str):
    """Each impl's Trainer at full width; returns ({path: launches},
    {path: median ms/step})."""
    kernels = all_kernels()
    cfg = _cfg(64)
    G, B = cfg.model.num_crops, cfg.train.batch_size
    N, C = cfg.data.num_points, cfg.model.in_features
    g = torch.Generator().manual_seed(SEED + 3)
    batches = torch.randn(2, G, B, N, C, generator=g).to(dev)
    out, medians = {}, {}
    for impl in IMPLS:
        out[impl], medians[impl] = _run_path(
            dev, impl, 40 if impl == "pair3" else 20, batches, g, kernels,
            card, profile, PATHS[impl])
        torch.cuda.empty_cache()
    for impl, steps in PLAIN_PATHS:
        out[impl], medians[impl] = _run_path(
            dev, impl, steps, batches, g, kernels, card, False,
            {"select_gather": 1})
        torch.cuda.empty_cache()
    for label, impl, steps, want in BF16_PATHS:
        out[label], medians[label] = _run_path(
            dev, impl, steps, batches, g, kernels, card,
            profile and impl in ("pair3", "pallas"), want, label,
            dtype="bfloat16")
        torch.cuda.empty_cache()
    for label, si, gi, steps, want in PALLAS_PATHS:
        out[label], medians[label] = _run_path(
            dev, "pallas", steps, batches, g, kernels, card,
            profile and label == "pallas", want, label, si, gi)
        torch.cuda.empty_cache()
    if PARENT:
        parent_step_ab(dev, batches, g, kernels, card, profile)
    return out, medians


#: --parent: the Trainer steps parent_step_ab runs with the parent's
#: launchers of the named kernels (the f32 B6 of pair and B8b of
#: hybrid2), each against this tree's: (BF16_PATHS label, "pallas f32",
#: "hybrid2 f32" or "pair f32", kernels).
PARENT_STEPS = (("pair f32", ("sa_bwd_sweep2_full",)),
                ("hybrid2 f32", ("sa_bwd2_sweep2",)))
#: --parent --profile: profiled steps of each of parent_step_ab's runs.
PARENT_PROF_STEPS = 3


def parent_step_ab(dev, batches, g, kernels, card, profile: bool):
    """--parent: each PARENT_STEPS Trainer step with this tree's
    kernels and with the parent tree's launchers of its named kernels
    (every other kernel this tree's; each launched at the parent's grid,
    parent_grid_swaps), in turns: parent, this tree, this tree, parent, 20
    timed steps each after 2 warm-up steps (_run_path: its launch counts
    checked); with --profile PARENT_PROF_STEPS profiled steps of each run,
    their kernel time split into the kernels only one side launches (the
    swapped ones) and every other kernel. Prints the medians; returns
    {label: [ms, ms, ms, ms]}."""
    import ctypes
    from facl_tpu_torch.ops import _build
    paths = {label: (impl, want, "bfloat16")
             for label, impl, _, want in BF16_PATHS}
    paths["pallas f32"] = ("pallas", PALLAS_PATHS[0][4], "float32")
    paths["hybrid2 f32"] = ("hybrid2", PATHS["hybrid2"], "float32")
    paths["pair f32"] = ("pair", PATHS["pair"], "float32")
    out = {}
    for label, names in PARENT_STEPS:
        impl, want, dtype = paths[label]
        swaps, grids = {}, []
        for name in names:
            lib_name, launcher, per_sm = PARENT_AB[name]
            key = (lib_name, launcher)
            if key in swaps:
                continue
            ours = _build._FUNCTIONS[key]
            pfn = getattr(PARENT[lib_name], launcher)
            pfn.argtypes, pfn.restype = ours[1].argtypes, ctypes.c_int
            swaps[key] = (ours, (PARENT[lib_name], pfn))
            grids += parent_grid_swaps(lib_name, per_sm)
        out[label] = _parent_step_turns(dev, batches, g, kernels, card,
                                        profile, label, impl, want, names,
                                        swaps, grids, dtype)
    return out


def _parent_step_turns(dev, batches, g, kernels, card, profile, label, impl,
                       want, names, swaps, grids, dtype):
    from facl_tpu_torch.ops import _build
    names = " and ".join(names)
    profs = {True: [], False: []}     # parent? -> [{kernel: ms} a step]

    def run(parent):
        for key, (ours, theirs) in swaps.items():
            _build._FUNCTIONS[key] = theirs if parent else ours
        try:
            tag = "the parent's" if parent else "this tree's"
            with swapped(grids if parent else []):
                return _run_path(dev, impl, 20, batches, g, kernels, card,
                                 profile, want, f"{label} with {tag} {names}",
                                 dtype=dtype,
                                 prof_steps=PARENT_PROF_STEPS,
                                 prof_out=profs[parent])[1]
        finally:
            for key, (ours, _) in swaps.items():
                _build._FUNCTIONS[key] = ours
            torch.cuda.empty_cache()
    ms = [run(True), run(False), run(False), run(True)]
    print(f"A/B {label} step in turns (parent's {names}, this tree's, "
          f"this tree's, parent's) on {card}: "
          f"{' / '.join(f'{v:.2f}' for v in ms)} ms/step (medians of 20); "
          f"parent mean {(ms[0] + ms[3]) / 2:.2f}, this tree "
          f"{(ms[1] + ms[2]) / 2:.2f}", flush=True)
    if profile:
        seen = {p: set().union(*steps) for p, steps in profs.items()}
        parts = {}
        for parent, steps in profs.items():
            own = seen[parent] - seen[not parent]
            parts[parent] = [(sum(k.values()),
                              sum(v for n, v in k.items() if n in own))
                             for k in steps]

        def spread(vals):
            vals = sorted(vals)
            return (f"median {statistics.median(vals):.3f} (range "
                    f"{vals[0]:.3f}-{vals[-1]:.3f})")
        for parent, tag in ((True, "the parent's"), (False, "this tree's")):
            pv = parts[parent]
            print(f"A/B {label} profiled kernel time with {tag} {names} "
                  f"on {card}, ms a step over {len(pv)} profiled steps: all "
                  f"kernels {spread([a for a, _ in pv])}; the kernels only "
                  f"this side launches {spread([o for _, o in pv])}; every "
                  f"other kernel {spread([a - o for a, o in pv])}",
                  flush=True)
    return ms


def all_kernels():
    """Every kernel wrapper of the port (each counts its launches)."""
    from facl_tpu_torch.ops import gather as GA
    from facl_tpu_torch.ops import select as SEL
    return SEL.KERNELS + GA.KERNELS + tuple(k for m in sa_modules()
                                            for k in m.KERNELS)


def kernel_ms(events) -> dict:
    """Device ms by kernel name of a profiler's events: every event that
    ran on the card but user annotations. An annotation's device range
    (``record_function``'s, e.g. ``Optimizer.step#Adam.step``) spans the
    kernels launched inside it and the idle gaps between them, so it would
    count their time twice and the gaps as busy. The one definition of
    kernel time: the profiled steps' busy sums and parent_step_ab's
    split."""
    kern = {}
    for x in events:
        if x.device_type == torch.autograd.DeviceType.CUDA and \
                not x.is_user_annotation:
            kern[x.name] = kern.get(x.name, 0.0) + \
                x.self_device_time_total / 1e3
    return kern


def _run_path(dev, impl, steps, batches, g, kernels, card, profile, want,
              label=None, select_impl="auto", gather_impl="auto",
              dtype="float32", prof_steps=1, prof_out=None):
    from facl_tpu_torch.train import Trainer
    G, B, N = batches.shape[1:4]
    label = label or impl
    tr = Trainer(_cfg(B, impl, select_impl, gather_impl, dtype),
                 steps_per_epoch=100, device=dev)
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
          f"gather_impl={gather_impl}) on {card}: B={B} G={G} N={N} "
          f"{'bf16' if dtype == 'bfloat16' else 'f32'}, "
          f"{steps} steps: median {ms:.2f} ms/step (min {per[0]:.2f}, "
          f"quartiles {per[steps // 4]:.2f}-{per[3 * steps // 4]:.2f}, max "
          f"{per[-1]:.2f}; wall-clock mean {wall:.2f}), {B / ms * 1e3:.1f} "
          f"clips/s at the median, peak {peak:.2f} GiB; losses first "
          f"{losses[0]:.4f} last {losses[-1]:.4f}; launches "
          f"{ {n: c for n, c in launches.items() if c} }", flush=True)
    for n in range(prof_steps if profile else 0):
        from torch.profiler import ProfilerActivity, profile as prof
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            s.record()
            state, m = tr.step_fn(state, batches[0], generator=g)
            e.record()
            torch.cuda.synchronize()
        span = s.elapsed_time(e)
        kern = kernel_ms(p.events())
        if prof_out is not None:
            prof_out.append(kern)
        busy = sum(kern.values())
        table = "" if n else "\n" + p.key_averages().table(
            sort_by="self_cuda_time_total", row_limit=25)
        which = "" if prof_steps == 1 else f" ({n + 1} of {prof_steps})"
        print(f"profile of one {label} step{which}: device busy {busy:.2f} "
              f"ms (sum of kernel times) over the step's own span of "
              f"{span:.2f} ms (CUDA events; the profiler's host overhead "
              f"lengthens it): idle share {max(0.0, 1 - busy / span):.3f}"
              + table, flush=True)
    return launches, ms


#: The pipeline phase's tree: NTU-60 names, both protocols with at least
#: 64 training videos (xview 128, xsub 96), about 230 MiB of .npy files.
PIPE_VIDEOS = 192
PIPE_B = 64
CONFIGS = {"motion": ("configs/motion_ntu60_xview.json", "xview"),
           "appearance": ("configs/appearance_ntu60_xsub.json", "xsub")}


def pipeline_names(n: int) -> list:
    """``n`` distinct NTU-60 names: setups 1-17, actions 1-60, cameras
    1-3, performers alternately in and out of the xsub training table."""
    from facl_tpu_torch.data.ntu import TRAIN_IDS_60
    others = [p for p in range(1, 41) if p not in TRAIN_IDS_60]
    names = []
    for i in range(n):
        ids = TRAIN_IDS_60 if (i // 3) % 2 == 0 else others
        names.append(f"S{i % 17 + 1:03d}C{i % 3 + 1:03d}"
                     f"P{ids[(i // 6) % len(ids)]:03d}R{i // 96 + 1:03d}"
                     f"A{i % 60 + 1:03d}")
    check(len(set(names)) == n, "pipeline tree: duplicate names")
    return sorted(names)


def write_tree(root: str, n: int, seed: int) -> list:
    """A random tree in the generator's layout (facl_tpu_torch/data/
    dataset.py): for every video and resolution 60/30/10 the raw (2048, 8)
    and appearance (10, 2048, 4) clouds, and the (2048, 8) key points at
    resolution 60, float32. xyz fill a body-sized slab (extent 0.5 x 1 x
    0.3, the y extent normalised to 1 as the generator does), so ball
    queries at r^2 = 0.06 hold more than K points; channels 4-7 are zero
    on about half the rows (the ti views sample where they are not)."""
    import numpy as np
    names = pipeline_names(n)
    rng = np.random.default_rng(seed)
    half = np.array([0.25, 0.5, 0.15], np.float32)

    def cloud(shape, c):
        a = rng.standard_normal((*shape, c), dtype=np.float32)
        a[..., :3] = rng.uniform(-half, half, (*shape, 3))
        if c == 8:
            a[..., 4:] *= rng.uniform(size=(*shape, 4)) < 0.5
        return a
    for res in (60, 30, 10):
        for sub in ("raw", "app") + (("others",) if res == 60 else ()):
            os.makedirs(os.path.join(root, f"Resolution{res}", sub))
    for name in names:
        for res in (60, 30, 10):
            d = os.path.join(root, f"Resolution{res}")
            np.save(os.path.join(d, "raw", name + ".npy"), cloud((2048,), 8))
            np.save(os.path.join(d, "app", name + "_app.npy"),
                    cloud((10, 2048), 4))
        np.save(os.path.join(root, "Resolution60", "others",
                             name + "_key.npy"), cloud((2048,), 8))
    return names


def _host_ms(fn, n: int = 3) -> float:
    """Median host ms of ``n`` calls of ``fn`` (after one warm-up)."""
    fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def _feature_files(d: str, names, dim: int):
    import numpy as np
    files = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
    check(files == sorted(n + ".npy" for n in names),
          f"extract {d}: {len(files)} files for {len(names)} videos")
    out = {}
    for f in files:
        a = np.load(os.path.join(d, f))
        check(a.shape == (dim,) and a.dtype == np.float32 and
              bool(np.isfinite(a).all()), f"extract {d}/{f}: {a.shape} "
                                          f"{a.dtype} or not finite")
        out[f] = a
    return out


def _eval_cpu_vs_card(dev, ckpt, cfg_path, crops):
    """make_eval_step on the CPU and on the card, same restored weights
    and running statistics, same crops: f32 at relative 1e-4 (of the
    output's largest magnitude) on the rows whose stage-2 pool argmax
    agrees between the devices (rows where it flipped are counted), bf16
    at 5e-2 on every row."""
    import dataclasses
    from facl_tpu_torch.config import Config
    from facl_tpu_torch.train import Trainer, make_eval_step, restore_latest
    with open(cfg_path) as f:
        base = Config.from_json(f.read())
    for dtype, bar in (("float32", 1e-4), ("bfloat16", 5e-2)):
        cfg = base.replace(model=dataclasses.replace(base.model,
                                                     compute_dtype=dtype))
        outs = []
        for d in ("cpu", dev):
            tr = Trainer(cfg, 1, device=d)
            st = tr.init_state(SEED)
            restore_latest(ckpt, st)
            seen = []
            h = st.model.stage2_mlp.register_forward_hook(
                lambda m, i, o: seen.append(o.float()))
            x, xg = make_eval_step(st.model, tr.cfg, tr.g_cfg)(
                crops.to(d))
            h.remove()
            local = seen[0]
            G = cfg.model.num_crops
            outs.append((x.cpu(), xg.cpu(), local.argmax(1).cpu(),
                         local.reshape(-1, G * local.shape[1],
                                       local.shape[2]).argmax(1).cpu()))
        (xc, gc, ac, bc), (xk, gk, ak, bk) = outs
        flip_l = (ac != ak).any(1)                   # crops
        flip_g = (bc != bk).any(1)                   # videos
        errs = []
        for a, b, flip in ((xk, xc, flip_l), (gk, gc, flip_g)):
            keep = ~flip if dtype == "float32" else torch.ones_like(flip)
            scale = float(b.abs().max())
            err = float((a - b)[keep].abs().max()) / scale
            check(err <= bar, f"eval cpu-vs-card {dtype}: {err:.3e} > {bar}")
            errs.append(err)
        print(f"eval step cpu-vs-card {dtype} ({crops.shape[1]} videos, "
              f"restored after training): x {errs[0]:.3e}, x_global "
              f"{errs[1]:.3e} of scale (bar {bar:g}); stage-2 pool argmax "
              f"flipped on {int(flip_l.sum())} of {flip_l.numel()} crops, "
              f"{int(flip_g.sum())} of {flip_g.numel()} videos"
              f"{' (held all the same at bf16)' if dtype != 'float32' else ''}",
              flush=True)


def phase_pipeline(dev, card: str, medians: dict):
    """The user's pipeline on the card, through the port's CLIs in this
    process, on a random tree written here (``write_tree``): motion
    pretrain on the shipped motion config (one epoch, then --resume to
    two), appearance pretrain on the shipped appearance config (one
    epoch), one pretrain step with --sa-impl auto (bf16 pair3), extract
    both streams (motion twice: bit-equal), the probe. Checks and times
    the loader, the crop factory, the CLI epochs, extraction and the
    probe; returns {path: launches} of the pipeline's kernel paths."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    from facl_tpu_torch.cli import extract, pretrain, probe
    from facl_tpu_torch.config import Config
    from facl_tpu_torch.data import CropLoader, NTUPointDataset, native
    from facl_tpu_torch.data.crops import ClipSources, make_crops_batch
    from facl_tpu_torch.train import Trainer, make_eval_step, \
        make_grouping_fn, restore_latest
    from facl_tpu_torch.utils import setup_logging
    here = os.path.dirname(os.path.abspath(__file__))
    kernels = all_kernels()
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="pipeline-", dir=os.path.join(here,
                                                                "build"))
    out = {}

    def counted(fn):
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return res, dt, {k.__name__: k.launches for k in kernels
                         if k.launches}
    try:
        t0 = time.perf_counter()
        root = os.path.join(tmp, "tree")
        names = write_tree(root, PIPE_VIDEOS, SEED + 9)
        mib = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in
                  os.walk(root) for f in fs) / 2**20
        print(f"pipeline tree: {len(names)} videos, {mib:.1f} MiB, written "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        check(native.native_available(),
              "the native .npy loader did not build (g++)")

        # The loader (host) and the crop factory (device) at B = 64.
        pin = dev.type == "cuda"
        for stream in CONFIGS:
            dcfg = _data_cfg(here, stream)
            ds = NTUPointDataset(root, dcfg, train=True)
            idxs = list(range(PIPE_B))
            nat = _host_ms(lambda: ds.load_batch_native(idxs, pin=pin))
            nump = _host_ms(lambda: ds.load_batch_numpy(idxs, pin=pin))
            # The native load alone by thread count (the loader's is 4).
            per = [ds.paths(ds.names[ds.indices[i]]) for i in idxs]
            bufs = [torch.empty((PIPE_B, *sh), pin_memory=pin)
                    for sh in ds.file_shapes()]
            by_threads = {t: _host_ms(lambda: [native.load_into(
                [p[k] for p in per], b, num_threads=t)
                for k, b in enumerate(bufs)])
                for t in (1, 2, 4, 8)}
            srcs, _, _ = ds.load_batch(idxs, pin=pin)
            nbytes = sum(f.numel() * 4 for f in srcs)
            h2d, h2d_us = device_ms(lambda: [f.to(dev, non_blocking=True)
                                             for f in srcs])
            dsrc = ClipSources(*(f.to(dev) for f in srcs))
            g = torch.Generator(device=dev).manual_seed(SEED)
            crops_ms, crops_us = device_ms(
                lambda: make_crops_batch(g, dsrc, dcfg))
            crops = make_crops_batch(g, dsrc, dcfg)
            check(crops.shape == (10, PIPE_B, 512, 4) and
                  bool(torch.isfinite(crops).all()), "crop factory output")
            print(f"loader {stream} on {card}: {PIPE_B}-video batch of "
                  f"{nbytes / 2**20:.1f} MiB ({len(idxs) * 5} files), host "
                  f"{nat:.2f} ms native, {nump:.2f} ms NumPy (median of 3, "
                  f"page cache warm{', into pinned memory' if pin else ''}; "
                  f"native load_into alone by threads: "
                  f"{ {t: round(v, 2) for t, v in by_threads.items()} } ms); "
                  f"host-to-device "
                  f"copy {h2d:.3f} ms on the device ({h2d_us:.0f} us host); "
                  f"crop factory {crops_ms:.3f} ms on the device, "
                  f"{crops_us:.0f} us host per batch", flush=True)

        cks = {s: os.path.join(tmp, f"ck_{s}") for s in CONFIGS}
        feats = {s: os.path.join(tmp, f"feat_{s}") for s in CONFIGS}

        def common(stream):
            cfg_path, protocol = CONFIGS[stream]
            return ["--root", root, "--stream", stream, "--protocol",
                    protocol, "--config", os.path.join(here, cfg_path),
                    "--batch-size", str(PIPE_B), "--device", str(dev)]
        # Pretrain: the shipped configs as they are (bf16, reference).
        hist, dt, _ = counted(lambda: pretrain.main(
            common("motion") + ["--epochs", "1", "--out", cks["motion"]]))
        hist2, dt2, _ = counted(lambda: pretrain.main(
            common("motion") + ["--epochs", "2", "--resume", "--out",
                                cks["motion"]]))
        with open(os.path.join(cks["motion"], "index.json")) as f:
            idx = json.load(f)
        check(idx["latest_epoch"] == 1 and len(hist) == len(hist2) == 1,
              f"motion pretrain/resume: index {idx}, epochs run "
              f"{len(hist)}, {len(hist2)}")
        ref = medians["reference bf16"]
        n_train = {s: len(NTUPointDataset(root, _data_cfg(here, s)))
                   for s in CONFIGS}
        for label, h, t in (("epoch 0", hist[0], dt),
                            ("epoch 1 (resumed)", hist2[0], dt2)):
            check(math.isfinite(h["loss"]), f"motion pretrain loss {h}")
            print(f"pretrain CLI motion (shipped config: bf16 reference) "
                  f"{label} on {card}: {h['clips_per_sec']:.1f} clips/s over "
                  f"the epoch ({n_train['motion']} videos, "
                  f"{n_train['motion'] // PIPE_B} steps; loss "
                  f"{h['loss']:.4f}); "
                  f"the same config's step-only median in the main phase: "
                  f"{ref:.2f} ms/step, {PIPE_B / ref * 1e3:.1f} clips/s; CLI "
                  f"call {t:.2f} s", flush=True)
        hist, dt, _ = counted(lambda: pretrain.main(
            common("appearance") + ["--epochs", "1", "--out",
                                    cks["appearance"]]))
        check(math.isfinite(hist[0]["loss"]), f"appearance loss {hist}")
        print(f"pretrain CLI appearance (shipped config: bf16 reference) "
              f"epoch 0 on {card}: {hist[0]['clips_per_sec']:.1f} clips/s "
              f"({n_train['appearance']} videos, "
              f"{n_train['appearance'] // PIPE_B} steps; loss "
              f"{hist[0]['loss']:.4f}); CLI call "
              f"{dt:.2f} s", flush=True)
        hist, dt, launches = counted(lambda: pretrain.main(
            common("appearance") + ["--epochs", "1", "--sa-impl", "auto",
                                    "--out", os.path.join(tmp, "ck_auto")]))
        want = dict(BF16_PATHS[0][3])
        check(launches == want, f"pretrain --sa-impl auto: launches "
                                f"{launches}, expected {want}")
        check(math.isfinite(hist[0]["loss"]), f"auto loss {hist}")
        out["pretrain auto (bf16 pair3) step"] = launches
        print(f"pretrain CLI appearance --sa-impl auto (bf16 pair3), one "
              f"step on {card}: loss {hist[0]['loss']:.4f}, launches "
              f"{launches}; the same path's step-only median "
              f"{medians['pair3 bf16']:.2f} ms/step; CLI call {dt:.2f} s",
              flush=True)

        # Extraction: both splits, unshuffled, every video; B1 once a
        # batch (the eval SA stage is the bf16 reference: no sweep).
        files = {}
        for stream in CONFIGS:
            n, dt, launches = counted(lambda: extract.main(
                common(stream) + ["--checkpoint", cks[stream], "--out",
                                  feats[stream]]))
            ds = [NTUPointDataset(root, _data_cfg(here, stream), train=t)
                  for t in (True, False)]
            nb = sum(-(-len(d) // PIPE_B) for d in ds)
            check(launches == {"select_gather": nb},
                  f"extract {stream}: launches {launches}, expected "
                  f"select_gather x {nb} batches")
            out[f"extract {stream}"] = launches
            files[stream] = _feature_files(feats[stream], names, 11 * 512)
            print(f"extract CLI {stream} on {card}: {n} files of (5632,) in "
                  f"{nb} batches, B1 launched {launches.get('select_gather', 0)} "
                  f"times; CLI call {dt:.2f} s ({dt / nb * 1e3:.1f} ms a "
                  f"batch, restore and loader start included)", flush=True)
        again = os.path.join(tmp, "feat_motion_again")
        extract.main(common("motion") + ["--checkpoint", cks["motion"],
                                         "--out", again])
        second = _feature_files(again, names, 11 * 512)
        check(all(np.array_equal(files["motion"][f], second[f])
                  for f in second), "extract motion: a second run with the "
                                    "same seed gave other features")
        print("extract CLI motion again (same seed): every feature "
              "bit-equal", flush=True)
        _dp_clis(dev, card, root, common("motion"),
                 os.path.join(tmp, "ck_dp"), tmp)

        # Extraction step alone, f32 and bf16, at B = 64; CPU vs card.
        ds = NTUPointDataset(root, _data_cfg(here, "motion"), train=True)
        crops, _, _ = next(iter(CropLoader(ds, PIPE_B, seed=SEED,
                                           shuffle=False,
                                           device=dev).epoch(0)))
        with open(os.path.join(here, CONFIGS["motion"][0])) as f:
            base = Config.from_json(f.read())
        for dtype in ("float32", "bfloat16"):
            cfg = base.replace(model=dataclasses.replace(
                base.model, compute_dtype=dtype))
            tr = Trainer(cfg, 1, device=dev)
            st = tr.init_state(SEED)
            restore_latest(cks["motion"], st)
            step = make_eval_step(st.model, tr.cfg, tr.g_cfg)
            ms, us = device_ms(lambda: step(crops), n=10)
            print(f"extraction step {dtype} (motion, restored) on {card}: "
                  f"{ms:.2f} ms on the device, {us / 1e3:.2f} ms host per "
                  f"{PIPE_B}-video batch", flush=True)
            del tr, st, step
            torch.cuda.empty_cache()
        _eval_cpu_vs_card(dev, cks["motion"],
                          os.path.join(here, CONFIGS["motion"][0]),
                          crops[:, :8].contiguous())

        # Approximate kNN (grouping.method "approx") on these crops: the
        # plain selection, then B5a (gather_impl auto), equal to the same
        # selection with torch.gather; against the CPU, neighbourhoods
        # whose sets differ are counted (distances rounded otherwise at
        # the K-th neighbour or the radius).
        g_cfg = dataclasses.replace(base.grouping, method="approx")
        pts = crops.transpose(0, 1)
        (neigh, cent), _, launches = counted(
            lambda: make_grouping_fn(g_cfg, "bskc")(pts))
        check(launches == {"gather_rows": 1},
              f"approx kNN: launches {launches}, expected gather_rows x 1")
        out["approx kNN grouping"] = launches
        plain, _ = make_grouping_fn(dataclasses.replace(
            g_cfg, gather_impl="xla"), "bskc")(pts)
        check(torch.equal(neigh, plain), "approx kNN: B5a differs from "
                                         "torch.gather on the same idx")
        on_cpu, _ = make_grouping_fn(g_cfg, "bskc")(pts.cpu())
        differ = (neigh.cpu().sort(-2).values !=
                  on_cpu.sort(-2).values).flatten(-2).any(-1)
        print(f"approx kNN on {card}: {tuple(neigh.shape)}, B5a once, "
              f"equal to torch.gather; {int(differ.sum())} of "
              f"{differ.numel()} neighbourhoods differ from the CPU's as "
              f"sets", flush=True)

        # The probe on both streams' features (xview, 50 epochs).
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            best = probe.main(["--root", root, "--motion-features",
                               feats["motion"], "--appearance-features",
                               feats["appearance"], "--device", str(dev)])
        dt = time.perf_counter() - t0
        setup_logging()                  # off the captured stream again
        check(f"top1={best['top1']:.2f}" in buf.getvalue().splitlines()
              and 0.0 <= best["top1"] <= 100.0, f"probe output {best}")
        n_test = len(NTUPointDataset(root, _data_cfg(here, "motion"),
                                     train=False))
        print(f"probe CLI on {card}: {dt:.2f} s for 50 epochs "
              f"({n_train['motion']} train / {n_test} test videos, 11264-d; "
              f"random features: top-1 {best['top1']:.2f}% is chance); "
              f"printed top1={best['top1']:.2f}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# -- phase 6b: SwAV and CLD ----------------------------------------------

#: The shipped configuration that turns SwAV on.
SWAV_CONFIG = "configs/dual_ntu120_large_batch.json"
SWAV_WARM, SWAV_TIMED = 2, 5
#: The main path with SwAV and CLD: pair3 bf16 at bench.py's batch.
SWAV_MAIN_B, SWAV_MAIN_STEPS = 64, 20
#: The small-width step of the CPU-vs-card and queue-gate checks.
SWAV_SMALL_B = 8


@contextlib.contextmanager
def kmeans_labels(store: list):
    """Record every k-means's final labels (on the CPU) into ``store``."""
    from facl_tpu_torch.losses import cld as CLD
    km = CLD.kmeans

    def capture(x, *args, **kwargs):
        labels, c = km(x, *args, **kwargs)
        store.append(labels.cpu())
        return labels, c
    CLD.kmeans = capture
    try:
        yield
    finally:
        CLD.kmeans = km


def filled_queue(cfg, seed: int) -> torch.Tensor:
    """A full SwAV queue (G-1, Q, D) of unit rows from ``seed``, on the
    CPU: its last slot is set, so the queue scores (queue_on)."""
    Q = cfg.train.batch_size * cfg.loss.swav_queue_factor
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(cfg.model.num_crops - 1, Q, cfg.model.embed_dim,
                    generator=g)
    return q / q.norm(dim=-1, keepdim=True)


def _swav_cfg(cfg, **loss):
    import dataclasses
    return cfg.replace(loss=dataclasses.replace(cfg.loss, **loss))


def _swav_small_cfg(B, **loss):
    """A small-width model (the SA stage plain: reference) with SwAV and
    CLD on; B1 groups it on the card."""
    import dataclasses
    cfg = _cfg(B, "reference")
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, sa_widths=(16, 16, 32), stage2_widths=(32, 64),
        fc_hidden=64, embed_dim=32, num_prototypes=16))
    return _swav_cfg(cfg, **dict(dict(use_swav=True, use_cld=True,
                                      cld_clusters=4, cld_kmeans_iters=5,
                                      swav_queue_start_epoch=0), **loss))


def _timed_steps(tr, st, batches, warm, steps, epoch, kernels, g):
    """``_timed`` on the Trainer's step at ``epoch``. Returns (state, ms
    per step sorted, launches, last metrics, peak GiB)."""
    st, per, launches, metrics, peak = _timed(
        lambda s, b: tr.step_fn(s, b, generator=g, epoch=epoch), st,
        batches, warm, steps, kernels)
    return st, per, launches, metrics[-1], peak


def _swav_step(d, cfg, sd, queue, pts, perm, epoch):
    """One step on device ``d`` from ``sd`` and ``queue``: metrics, the
    new queue, the gradients, the decisions (``_decisions``) and the
    k-means labels."""
    from facl_tpu_torch.train import Trainer
    tr = Trainer(cfg, 100, device=d)
    st = tr.init_state(SEED)
    st.model.load_state_dict(sd)
    st.swav_queue = None if queue is None else queue.to(d)
    dec, labels = {}, []
    with _decisions(st.model, cfg.model.sa_impl, pts.shape[1], dec), \
            kmeans_labels(labels):
        st, m = tr.step_fn(st, pts.to(d), perm=perm, epoch=epoch)
    return dict(metrics={n: float(v) for n, v in m.items()},
                queue=None if st.swav_queue is None else st.swav_queue.cpu(),
                grads={n: p.grad.detach().cpu() for n, p in
                       st.model.named_parameters() if p.grad is not None},
                dec=dec, labels=labels)


def _swav_grad_bars(label, g1, gk, flips, km_flips, bar):
    """Phase 3's bars (``_dp_grad_bars``) where no k-means label flipped;
    a flipped label moves its cluster's centroid and so the cotangent of
    every embedding, so then the gradients are held by relative L2 alone
    (every entry counts as touched, as a flipped pool's are)."""
    if km_flips == 0:
        return _dp_grad_bars(label, g1, gk, flips, bar)
    l2 = max(_rel_l2(gk[n], a) for n, a in g1.items()
             if not n.startswith(DP_ABSORBED))
    check(l2 <= 1e-2, f"{label}: gradient relative L2 {l2:.3e} > 1e-2")
    return (f"relative L2 {l2:.3e} (bar 1e-2); {km_flips} k-means labels "
            "flipped, so no entry is held at the max-abs bar")


def _profile_once(fn, label: str):
    """One call of ``fn`` under torch.profiler: the device's busy sum
    (``kernel_ms``) over the call's span and the top of the table."""
    from torch.profiler import ProfilerActivity, profile as prof
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
    span = s.elapsed_time(e)
    busy = sum(kernel_ms(p.events()).values())
    print(f"profile of one {label}: device busy {busy:.2f} ms over the "
          f"span of {span:.2f} ms: idle share "
          f"{max(0.0, 1 - busy / span):.3f}\n" + p.key_averages().table(
              sort_by="self_cuda_time_total", row_limit=20), flush=True)


def phase_swav(dev, card: str, medians: dict, profile: bool = False):
    """SwAV and CLD on the card: the shipped SwAV config at its width and
    batch (with SwAV off beside it), the main path (pair3 bf16) with SwAV
    and CLD, a small-width step CPU vs card, and the queue gate. Returns
    {path: launches}."""
    from facl_tpu_torch.config import Config
    from facl_tpu_torch.train import Trainer
    here = os.path.dirname(os.path.abspath(__file__))
    kernels = all_kernels()
    out = {}
    g = torch.Generator().manual_seed(SEED + 21)

    # 1. The shipped config as it is (bf16, reference, B=256, SwAV on),
    # at epoch 10 with a full queue, then with SwAV off.
    with open(os.path.join(here, SWAV_CONFIG)) as f:
        cfg = Config.from_json(f.read())
    check(cfg.loss.use_swav and cfg.train.batch_size == 256,
          f"{SWAV_CONFIG}: SwAV off or batch {cfg.train.batch_size}")
    G, B = cfg.model.num_crops, cfg.train.batch_size
    N, C = cfg.data.num_points, cfg.model.in_features
    batches = torch.randn(2, G, B, N, C, generator=g).to(dev)
    ms = {}
    for swav in (True, False):
        c = cfg if swav else _swav_cfg(cfg, use_swav=False)
        tr = Trainer(c, 100, device=dev)
        st = tr.init_state(SEED)
        if swav:
            st.swav_queue = filled_queue(c, SEED + 22).to(dev)
        st, per, launches, m, peak = _timed_steps(
            tr, st, batches, SWAV_WARM, SWAV_TIMED, 10, kernels, g)
        label = f"shipped SwAV config, SwAV {'on' if swav else 'off'}"
        check(launches == {"select_gather": SWAV_TIMED},
              f"{label}: launches {launches}")
        check(swav == ("loss_swav" in m), f"{label}: metrics {sorted(m)}")
        if swav:
            check(bool((st.swav_queue[:, -1].abs() > 0).any()),
                  f"{label}: the queue's last slot emptied")
        ms[swav] = statistics.median(per)
        out[label] = {k: v // SWAV_TIMED for k, v in launches.items()}
        print(f"{label} ({SWAV_CONFIG}: bf16, sa_impl "
              f"{tr.cfg.model.sa_impl}, B={B} G={G} N={N}, epoch 10, "
              f"queue {tuple(st.swav_queue.shape) if swav else None}) on "
              f"{card}: median {ms[swav]:.2f} ms/step (min {per[0]:.2f}, "
              f"max {per[-1]:.2f}; {SWAV_TIMED} steps after {SWAV_WARM}), "
              f"peak {peak:.2f} GiB; launches {launches}; last metrics "
              f"{ {k: round(v, 4) for k, v in m.items()} }", flush=True)
        del tr, st
        torch.cuda.empty_cache()
    print(f"SwAV's own cost on the shipped config on {card}: "
          f"{ms[True] - ms[False]:.2f} ms/step ({ms[True]:.2f} on vs "
          f"{ms[False]:.2f} off)", flush=True)
    del batches

    # 2. The main path with SwAV and CLD: pair3 bf16 at B=64 (the B2/B3
    # bf16 sweeps), cld_clusters 60 <= 3B.
    B = SWAV_MAIN_B
    c = _swav_cfg(_cfg(B, "pair3", dtype="bfloat16"), use_swav=True,
                  use_cld=True)
    batches = torch.randn(2, G, B, N, C, generator=g).to(dev)
    tr = Trainer(c, 100, device=dev)
    st = tr.init_state(SEED)
    st.swav_queue = filled_queue(c, SEED + 23).to(dev)
    st, per, launches, m, peak = _timed_steps(
        tr, st, batches, SWAV_WARM, SWAV_MAIN_STEPS, 10, kernels, g)
    want = {k: v * SWAV_MAIN_STEPS for k, v in BF16_LAUNCHES[
        "pair3 bf16"].items()}
    check(launches == want, f"pair3 bf16 SwAV+CLD: launches {launches}, "
                            f"expected {want}")
    med = statistics.median(per)
    base = medians.get("pair3 bf16", float("nan"))
    out["pair3 bf16 SwAV+CLD"] = BF16_LAUNCHES["pair3 bf16"]
    if profile:
        _profile_once(lambda: tr.step_fn(st, batches[0], generator=g,
                                         epoch=10),
                      f"pair3 bf16 SwAV+CLD step on {card}")
    print(f"main path pair3 bf16 with SwAV and CLD (cld_clusters "
          f"{c.loss.cld_clusters}, queue {tuple(st.swav_queue.shape)}, "
          f"epoch 10) on {card}: B={B}, median {med:.2f} ms/step (min "
          f"{per[0]:.2f}, max {per[-1]:.2f}; {SWAV_MAIN_STEPS} steps), "
          f"phase 4's pair3 bf16 median {base:.2f} ms/step: SwAV+CLD add "
          f"{med - base:.2f} ms/step; peak {peak:.2f} GiB; launches a step "
          f"{BF16_LAUNCHES['pair3 bf16']}; last metrics "
          f"{ {k: round(v, 4) for k, v in m.items()} }", flush=True)
    del tr, st, batches
    torch.cuda.empty_cache()

    # 3. CPU against the card: a small-width SwAV+CLD step.
    B = SWAV_SMALL_B
    c = _swav_small_cfg(B)
    gs = torch.Generator().manual_seed(SEED + 24)
    pts = torch.randn(G, B, N, C, generator=gs)
    perm = torch.randperm(G, generator=gs)
    queue = filled_queue(c, SEED + 25)
    sd = Trainer(c, 100, device="cpu").init_state(SEED).model.state_dict()
    cpu = _swav_step("cpu", c, sd, queue, pts, perm, 0)
    card_ = _swav_step(dev, c, sd, queue, pts, perm, 0)
    for k in ("loss", "loss_swav", "loss_cld"):
        check(math.isclose(card_["metrics"][k], cpu["metrics"][k],
                           rel_tol=2e-4), f"SwAV cpu-vs-card {k}: "
              f"{card_['metrics'][k]} vs {cpu['metrics'][k]}")
    check(torch.allclose(card_["queue"], cpu["queue"], rtol=2e-4,
                         atol=1e-5), "SwAV cpu-vs-card: queues differ")
    km = sum(int((a != b).sum()) for a, b in zip(cpu["labels"],
                                                 card_["labels"]))
    km_all = sum(a.numel() for a in cpu["labels"])
    flips = {n: (cpu["dec"][n] != card_["dec"][n]).reshape(
        -1, cpu["dec"][n].shape[-1]) for n in cpu["dec"]}
    got = _swav_grad_bars("SwAV cpu-vs-card", cpu["grads"], card_["grads"],
                          flips, km, 2e-4)
    print(f"SwAV+CLD cpu-vs-card, small width (SA {c.model.sa_widths}, "
          f"embed {c.model.embed_dim}, B={B}, cld_clusters "
          f"{c.loss.cld_clusters}) on {card}: loss "
          f"{card_['metrics']['loss']:.6f} vs {cpu['metrics']['loss']:.6f}, "
          f"swav {card_['metrics']['loss_swav']:.6f} vs "
          f"{cpu['metrics']['loss_swav']:.6f}, cld "
          f"{card_['metrics']['loss_cld']:.6f} vs "
          f"{cpu['metrics']['loss_cld']:.6f} (rtol 2e-4); queue within rtol "
          f"2e-4 / atol 1e-5; k-means labels flipped {km} of {km_all}; flipped "
          f"decisions { {n: int(f.sum()) for n, f in flips.items()} }; "
          f"gradients {got}", flush=True)

    # 4. The queue gate, on the card.
    c = _swav_small_cfg(B, use_cld=False, swav_queue_start_epoch=5)
    full = filled_queue(c, SEED + 26)
    zero = torch.zeros_like(full)
    runs = {name: _swav_step(dev, c, sd, q, pts, perm, ep) for name, q, ep
            in (("before", zero, 4), ("at, empty", zero, 5),
                ("none", None, 5), ("at, full", full, 5),
                ("after, full", full, 7), ("before, full", full, 4))}
    check(not runs["before"]["queue"].any(), "queue gate: filled before "
                                             "the start epoch")
    check(torch.equal(runs["before, full"]["queue"], full),
          "queue gate: a full queue moved before the start epoch")
    for name in ("at, empty", "at, full", "after, full"):
        q = runs[name]["queue"]
        old = zero if "empty" in name else full
        check(torch.equal(q[:, B:], old[:, :-B]) and bool(
            q[:, :B].abs().sum() > 0), f"queue gate {name}: not shifted "
                                       f"by B={B}")
    sw = {n: r["metrics"]["loss_swav"] for n, r in runs.items()}
    check(math.isclose(sw["at, empty"], sw["none"], rel_tol=1e-5),
          f"queue gate: an empty last slot scored ({sw})")
    check(abs(sw["at, full"] - sw["none"]) > 1e-4 * abs(sw["none"]),
          f"queue gate: a full queue did not score ({sw})")
    print(f"SwAV queue gate on {card} (start epoch 5, B={B}, queue "
          f"{tuple(full.shape)}): untouched at epoch 4, shifted by B at 5 "
          f"and 7; an empty last slot scores nothing (loss_swav "
          f"{sw['at, empty']:.6f} vs {sw['none']:.6f} without a queue), a "
          f"full one scores ({sw['at, full']:.6f})", flush=True)
    return out


# -- phase 6c: datagen ---------------------------------------------------

#: Synthetic NTU-sized clips a resolution, their frames, and the batch.
GEN_CLIPS, GEN_FRAMES, GEN_BATCH = 4, 72, 4
GEN_VIDEOS = 32


def _gen_clips(cfg, n: int, seed: int):
    """``n`` synthetic depth clips at the config's frame shape (the port's
    numpy ``synthetic_depth_clip``: the articulated, class-conditioned
    figure of its "instance" style, whose drift stays inside the grid
    over the clip; the "reference_window" style drifts 150 mm a frame,
    10.8 m over 72 frames, and its clips fall out of the 128 x 96 x 96
    grid), and their names."""
    import numpy as np
    from facl_tpu_torch.data.synthetic import synthetic_depth_clip
    names = [f"S001C00{1 + i % 3}P00{1 + i}R001A00{1 + i}" for i in range(n)]
    clips = [synthetic_depth_clip(np.random.default_rng(seed + i),
                                  n_frames=GEN_FRAMES,
                                  shape=cfg.image_shape, action=1 + i,
                                  num_actions=n, style="instance")
             for i in range(n)]
    return names, clips


def _gen_equal(a, b, what):
    import numpy as np
    for k in ("raw", "key", "app", "n_raw", "n_key"):
        check(np.array_equal(a[k], b[k]), f"datagen {what}: {k} differs")


def phase_datagen(dev, card: str, profile: bool = False, then=None):
    """The port's datagen at NTU size on the card, bit-equal to the CPU
    with the same draws; then generate --synthetic on the card and the
    shipped SwAV config pretrained on that tree, with a checkpoint and a
    --resume; then ``then(tree, tmp)``, if given, on the same tree (its
    {path: launches} joins the result) before the tree is deleted.
    Returns {path: launches}."""
    import shutil
    import tempfile

    import numpy as np
    from facl_tpu_torch.config import DatagenConfig
    from facl_tpu_torch.datagen import ClipGenerator
    here = os.path.dirname(os.path.abspath(__file__))
    kernels = all_kernels()
    cfg = DatagenConfig()
    names, clips = _gen_clips(cfg, GEN_CLIPS, SEED + 31)
    for res in cfg.resolutions:
        gen = ClipGenerator(cfg, max_frames=res, seed=SEED, device=dev)
        singles, t_single = [], []
        for clip, name in zip(clips, names):
            t0 = time.perf_counter()
            singles.append(gen.from_frames(clip, tag=name))
            t_single.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.reset_peak_memory_stats()
        t_batch = []
        for _ in range(2):
            t0 = time.perf_counter()
            batch = gen.from_frames_batch(clips, tags=names)
            t_batch.append((time.perf_counter() - t0) * 1e3 / len(clips))
        peak = torch.cuda.max_memory_allocated() / 2**30
        if profile and res == cfg.resolutions[0]:
            _profile_once(lambda: gen.from_frames_batch(clips, tags=names),
                          f"Resolution{res} clip batch of {len(clips)} on "
                          f"{card}")
        for name, a, b in zip(names, singles, batch):
            _gen_equal(a, b, f"Resolution{res} {name} batch vs single")
        t0 = time.perf_counter()
        cpu = ClipGenerator(cfg, max_frames=res, seed=SEED,
                            device="cpu").from_frames_batch(clips, tags=names)
        t_cpu = (time.perf_counter() - t0) * 1e3 / len(clips)
        for name, a, b in zip(names, batch, cpu):
            _gen_equal(a, b, f"Resolution{res} {name} card vs cpu")
        n_raw = [int(o["n_raw"]) for o in batch]
        n_key = [int(o["n_key"]) for o in batch]
        med_single = statistics.median(t_single)
        check(min(n_raw) > 0, f"datagen Resolution{res}: candidates raw "
                              f"{n_raw}")
        print(f"datagen Resolution{res} on {card}: {len(clips)} synthetic "
              f"clips of {GEN_FRAMES} frames {cfg.image_shape[0]}x"
              f"{cfg.image_shape[1]} (cap {res}), grid {cfg.grid_shape}, "
              f"S={cfg.sample_num}: clip_batch 1 {med_single:.1f} ms a "
              f"clip (first {t_single[0]:.1f}), clip_batch "
              f"{len(clips)} {t_batch[1]:.1f} ms a clip (first "
              f"{t_batch[0]:.1f}), peak {peak:.2f} GiB; CPU {t_cpu:.0f} ms a "
              f"clip; raw, key, app, n_raw, n_key bit-equal card vs CPU and "
              f"batch vs single; candidates raw {n_raw} key {n_key}",
              flush=True)

    # The second-level grouping routes through B1 on the card.
    from facl_tpu_torch.ops.grouping import group_points_level2
    gl = torch.Generator().manual_seed(SEED + 32)
    feats = torch.randn(64, 128, 3 + 64, generator=gl)
    feats[..., :3] *= 0.3
    for k in kernels:
        k.launches = 0
    neigh, cent = group_points_level2(feats.to(dev))
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels if k.launches}
    check(launches == {"select_gather": 1}, f"level-2 grouping: {launches}")
    want, _ = group_points_level2(feats)
    check(torch.equal(neigh.cpu(), want), "level-2 grouping: card vs CPU")
    print(f"group_points_level2 on {card}: features {tuple(feats.shape)} -> "
          f"{tuple(neigh.shape)}, launches {launches}, bit-equal to the CPU",
          flush=True)
    out = {"group_points_level2": launches}

    # The CLIs: generate --synthetic on the card, then the shipped SwAV
    # config pretrained on that tree (cut: batch 16 on a 32-video tree),
    # 11 epochs so that the queue opens at epoch 10, and a --resume.
    from facl_tpu_torch.cli import pretrain
    from facl_tpu_torch.train import Trainer, restore_latest
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="datagen-", dir=os.path.join(here, "build"))
    try:
        tree, ck = os.path.join(tmp, "tree"), os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m",
                            "facl_tpu_torch.cli.generate", "--synthetic",
                            str(GEN_VIDEOS), "--out", tree, "--device",
                            str(dev)],
                           cwd=here, capture_output=True, text=True,
                           timeout=600)
        dt = time.perf_counter() - t0
        check(r.returncode == 0, f"generate --synthetic: {r.stderr[-2000:]}")
        files = sorted(os.listdir(os.path.join(tree, "Resolution60", "raw")))
        check(len(files) == GEN_VIDEOS, f"generate wrote {len(files)} videos")
        raw = np.load(os.path.join(tree, "Resolution60", "raw", files[0]))
        check(raw.shape == (2048, 8) and bool(np.isfinite(raw).all()),
              f"generated raw {raw.shape}")
        print(f"generate --synthetic {GEN_VIDEOS} on {card}: {dt:.1f} s "
              "(process start included), the tree's layout and shapes as "
              "the pretrain CLI reads them", flush=True)
        common = ["--root", tree, "--config",
                  os.path.join(here, SWAV_CONFIG), "--batch-size", "16",
                  "--out", ck, "--device", str(dev)]
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        hist = pretrain.main(common + ["--epochs", "11"])
        dt = time.perf_counter() - t0
        check(len(hist) == 11 and all(math.isfinite(h["loss"]) and
                                      math.isfinite(h["loss_swav"])
                                      for h in hist), f"pretrain {hist}")
        out["pretrain SwAV config on the generated tree"] = {
            k.__name__: k.launches for k in kernels if k.launches}
        saved = {}
        for ep in (5, 10):
            p = os.path.join(ck, f"ckpt_epoch_{ep:05d}.pt")
            saved[ep] = torch.load(p, map_location="cpu",
                                   weights_only=True)["swav_queue"]
        check(not saved[5].any(), "pretrain: queue filled before epoch 10")
        check(bool(saved[10][:, :16].abs().sum() > 0) and not
              saved[10][:, 16:].any(), "pretrain: epoch 10 did not push "
                                       "one batch into the queue")
        from facl_tpu_torch.config import Config
        cfg_r = pretrain.build_config(argparse.Namespace(
            root=tree, stream="motion", dataset="ntu60", protocol="xview",
            batch_size=16, config=os.path.join(here, SWAV_CONFIG),
            dtype="bfloat16", sa_impl=None))
        st = restore_latest(ck, Trainer(cfg_r, 1, device=dev).init_state(1))
        check(torch.equal(st.swav_queue.cpu(), saved[10]),
              "resume: the queue differs from the saved one")
        hist2 = pretrain.main(common + ["--epochs", "12", "--resume"])
        check(len(hist2) == 1 and math.isfinite(hist2[0]["loss"]),
              f"pretrain --resume {hist2}")
        print(f"pretrain {SWAV_CONFIG} on the generated tree on {card}: "
              f"batch 16 (cut from 256: the tree holds {GEN_VIDEOS} videos), "
              f"11 epochs in {dt:.1f} s, losses {hist[0]['loss']:.4f} .. "
              f"{hist[-1]['loss']:.4f}, loss_swav {hist[-1]['loss_swav']:.4f}"
              f"; the queue empty at epoch 5, one batch in at epoch 10; "
              f"restored bit-equal; --resume to 12: loss "
              f"{hist2[0]['loss']:.4f}", flush=True)
        if then is not None:
            out.update(then(tree, tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# -- phase 6d: MoCo and the slow/fast encoder ----------------------------

#: (a) MoCo at full width: videos a view, the reference queue length,
#: warm-up and timed steps.
MOCO_B, MOCO_QUEUE, MOCO_WARM, MOCO_TIMED = 64, 9600, 3, 20
#: (c) slow/fast at full width: G crops of B videos, each crop one cloud
#: (the pretrain CLI's flattening), warm-up and timed steps.
SF_G, SF_B, SF_WARM, SF_TIMED = 10, 64, 3, 10
#: (b), (d): videos of the CPU-vs-card steps.
SMALL_B = 8
#: The slow/fast trainer's two groupings (slowfast_trainer.py defaults).
SF_SLOW_K, SF_FAST_K = 128, 64
#: Slow/fast parameters whose exact gradient is zero (a BatchNorm follows).
SF_ABSORBED = tuple(f"{b}.dense_{i}.bias" for b in ("slow1", "fast1",
                                                    "slow3", "fast3")
                    for i in range(3)) + ("head_slow.Dense_0.bias",
                                          "head_fast.Dense_0.bias")


def _moco_want(model_cfg):
    """B1 and, for pair3, each sweep at its dtype once a MoCo step (the
    key encoder's eval forward launches none)."""
    if model_cfg.sa_impl == "reference":
        return {"select_gather": 1}
    return BF16_LAUNCHES["pair3 bf16"] if \
        model_cfg.compute_dtype == "bfloat16" else PATHS["pair3"]


def _timed(step, st, batches, warm, steps, kernels):
    """``warm`` steps, then ``steps`` timed by CUDA events between steps,
    the launch counts zeroed just before them; every metric finite.
    Returns (state, ms per step sorted, launches, each timed step's
    metrics as floats, peak GiB of the timed steps)."""
    for i in range(warm):
        st, _ = step(st, batches[i % len(batches)])
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    metrics = []
    ev[0].record()
    for i in range(steps):
        st, m = step(st, batches[i % len(batches)])
        ev[i + 1].record()
        metrics.append(m)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels if k.launches}
    metrics = [{n: float(v) for n, v in m.items()} for m in metrics]
    for m in metrics:
        check(all(math.isfinite(v) for v in m.values()),
              f"not finite: {m}")
    per = sorted(ev[i].elapsed_time(ev[i + 1]) for i in range(steps))
    return (st, per, launches, metrics,
            torch.cuda.max_memory_allocated() / 2**30)


def _b1_twin(flat, S, K, r2, label):
    """B1 on ``flat`` bit-equal to its twin (phase 2's bar); returns its
    channel-major grouping."""
    from facl_tpu_torch.ops import select as SEL
    kg, ki = SEL.select_gather(flat, S, K, r2, return_idx=True)
    tg, ti = SEL.select_gather_plain(flat, S, K, r2)
    check(torch.equal(ki, ti) and torch.equal(kg, tg),
          f"{label}: B1 differs from its twin at {tuple(flat.shape)}, K={K}")
    return kg


def _b2a_check(x3, layers, label):
    """B2a (sa_fwd_layer12) against its twin at phase 2's bars, run to run
    bit-identical; returns max |kernel - twin|."""
    SP = sweep_modules()[0]
    from facl_tpu_torch.ops.sa_bwd import _fold_affine
    lp1, lp2, _ = layers
    R = x3.shape[0] * x3.shape[2]
    m1, v1 = SP._moments_from_gram(torch.einsum("bcn,bdn->cd", x3, x3),
                                   x3.sum((0, 2)), lp1.kernel, lp1.bias, R)
    mul1, shift1 = _fold_affine(lp1, m1, v1, 1e-5)
    a12 = (x3, lp1.kernel, lp1.bias, mul1, shift1, lp2.kernel, lp2.bias)
    p2, s2, ss2 = SP.sa_fwd_layer12_plain(*a12)
    k = SP.sa_fwd_layer12(*a12)
    check(all(torch.equal(a, b) for a, b in zip(k, SP.sa_fwd_layer12(*a12))),
          f"layer12 [{label}]: two runs differ")
    return max(row_err(k[0], p2, f"layer12 [{label}] p2"),
               acc_err(k[1], s2, f"layer12 [{label}] s"),
               acc_err(k[2], ss2, f"layer12 [{label}] ss"))


def _moco_kernels(dev, label, views, tr, st):
    """(a): the run's kernels against their twins at the shapes it gives
    them: B1 over the step's 2B clouds bit-equal; for pair3 the sweeps at
    the run's dtype on the query view's grouping (B clouds) with the
    model's SA weights and a randn cotangent, at phase 2's bars (f32:
    B2a here, B2b-B3c by check_b2b_b3; bf16: bf16_rows). Returns the
    reading."""
    from facl_tpu_torch.ops.fused_sa import SALayerParams
    g_cfg, m_cfg = tr.cfg.grouping, tr.cfg.model
    S, K, r2 = g_cfg.num_centroids, g_cfg.knn_k, g_cfg.radius_sq
    V, B, N, C = views.shape
    flat = views.reshape(V * B, N, C).contiguous()
    grouped = _b1_twin(flat, S, K, r2, f"moco {label}")
    if m_cfg.sa_impl != "pair3":
        return f"B1 over {V * B} clouds bit-equal to its twin"
    x = grouped[:B].clone()
    x[:, :3] -= flat[:B, :S, :3].transpose(1, 2)[..., None]
    x3 = x.reshape(B, C, S * K)
    del grouped, x
    layers = [SALayerParams(*(t.detach() for t in lp))
              for lp in st.model.sa_stage.layers()]
    g = torch.Generator().manual_seed(SEED + 41)
    dpooled = torch.randn(B * S, layers[-1].kernel.shape[1],
                          generator=g).to(dev)
    with torch.no_grad():
        if m_cfg.compute_dtype == "bfloat16":
            bf16_rows(x3, layers, dpooled, K)
            what = "the five bf16 sweeps at phase 2's bf16 bars (line above)"
        else:
            e = _b2a_check(x3, layers, f"moco {label}")
            check_b2b_b3(x3, layers, K, dpooled, f"moco {label}")
            what = (f"B2a max |kernel - twin| {e:.3e}, B2b-B3c at phase 2's "
                    "bars (line above)")
    return (f"B1 over {V * B} clouds bit-equal to its twin; at R="
            f"{B * S * K} {what}")


def _moco_step(d, cfg, views, B, halves=False):
    """One MoCo step on device ``d`` from the seed's weights and queue
    (made on the CPU, so alike on every device): loss, gradients before
    Adam, decisions (``_decisions``; none with ``halves``, which rounds
    as two ranks do: tests/torch_two_halves.py), queue and pointer."""
    from facl_tpu_torch.train import MoCoTrainer
    tr = MoCoTrainer(cfg, 100, queue_len=MOCO_QUEUE, device=d)
    st = tr.init_state(SEED, B)
    dec = {}
    with (_as_two_halves() if halves else
          _decisions(st.model, tr.cfg.model.sa_impl, B, dec)):
        st, m = tr.step_fn(st, views.to(d))
    return dict(loss=float(m["loss"]), dec=dec,
                grads={n: p.grad.detach().cpu() for n, p in
                       st.model.named_parameters() if p.grad is not None},
                queue=st.moco.queue.cpu(), ptr=st.moco.queue_ptr)


def _sf_cfg(B, dtype="float32"):
    import dataclasses
    cfg = _cfg(B, dtype=dtype)
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 name="slow_fast"))


@contextlib.contextmanager
def _sf_decisions(model, dec: dict):
    """Record the slow/fast forward's discrete decisions into ``dec``:
    every BatchNorm's ReLU mask (by the BatchNorm's name) and each shared
    MLP's pool argmax (``<mlp>.argmax``: over the neighbours for slow1 and
    fast1, over the groups for slow3 and fast3)."""
    from facl_tpu_torch.models.layers import BatchNorm
    hooks = []

    def keep(name, fn):
        def hook(mod, inp, out):
            dec[name] = fn(out).cpu()
        return hook
    for n, m in model.named_modules():
        if isinstance(m, BatchNorm):
            hooks.append(m.register_forward_hook(keep(
                n, lambda o: (o > 0).reshape(-1, o.shape[-1]))))
    for n, axis in (("slow1", 2), ("fast1", 2), ("slow3", 1), ("fast3", 1)):
        hooks.append(getattr(model, n).register_forward_hook(keep(
            f"{n}.argmax", lambda o, a=axis: o.argmax(a))))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


def _sf_touched(model_cfg, flips):
    """Which slow/fast parameter tensors (by module prefix) a flipped
    decision can move: a flip moves its own layer and every layer below
    it. Above a shared MLP's layer i sit its layers past i, its pool and
    its branch's head; the laterals feed the other branch's second MLP;
    the first MLPs feed both second MLPs (their own, and the other's
    through the lateral)."""
    def fl(name):
        return bool(flips.get(name, 0))
    out, chain = {}, {}
    for b in ("slow", "fast"):
        head = fl(f"head_{b}.BatchNorm_0")
        out[f"head_{b}.Dense_1."] = False
        out[f"head_{b}.Dense_0."] = out[f"head_{b}.BatchNorm_0."] = head
        above = head or fl(f"{b}3.argmax")
        for i in reversed(range(len(getattr(model_cfg, f"{b}_widths3")))):
            above = above or fl(f"{b}3.BatchNorm_{i}")
            out[f"{b}3.dense_{i}."] = out[f"{b}3.BatchNorm_{i}."] = above
        chain[b] = above
    for b, o in (("slow", "fast"), ("fast", "slow")):
        out[f"{o}_to_{b}."] = chain[b]
        above = chain[b] or chain[o] or fl(f"{b}1.argmax")
        for i in reversed(range(len(getattr(model_cfg, f"{b}_widths1")))):
            above = above or fl(f"{b}1.BatchNorm_{i}")
            out[f"{b}1.dense_{i}."] = out[f"{b}1.BatchNorm_{i}."] = above
    return out


def _sf_absorbed(g1):
    """The BN-absorbed biases and the gradients at round-off (at most
    1e-6 of the largest)."""
    top = max(float(t.abs().max()) for t in g1.values())
    return {n for n, t in g1.items() if n.startswith(SF_ABSORBED) or
            float(t.abs().max()) <= 1e-6 * top}


def _sf_grad_bars(label, model_cfg, g1, gk, flips, g64=None):
    """Phase 3's bars for slow/fast gradients ``gk`` against ``g1``:
    relative L2 at most 1e-2 on every gradient, max-abs at most 2e-4 of
    its scale on every tensor that no flipped decision reaches
    (``_sf_touched``), the BN-absorbed biases and round-off gradients at
    that bar of the largest. With the float64 step's gradients ``g64``,
    each bar is raised to twice ``g1``'s own distance from them where
    that is larger (``_f32_floor``, over the same tensors). Returns the
    reading."""
    top = max(float(t.abs().max()) for t in g1.values())
    absorbed = _sf_absorbed(g1)
    touched = _sf_touched(model_cfg, flips)
    l2 = max(_rel_l2(gk[n], a) for n, a in g1.items() if n not in absorbed)
    free = [n for n in g1 if n not in absorbed and
            not touched[n.rsplit(".", 1)[0] + "."]]
    bar, l2_bar = 2e-4, 1e-2
    if g64 is not None:
        bar = max(bar, 2 * _f32_floor(g64, g1, set(g1) - set(free))[0])
        l2_bar = max(l2_bar, 2 * _f32_floor(g64, g1, absorbed)[1])
    worst = max([float((gk[n] - g1[n]).abs().max()) /
                 max(float(g1[n].abs().max()), float(gk[n].abs().max()))
                 for n in free] + [0.0])
    for n in absorbed:
        err = float((gk[n] - g1[n]).abs().max()) / top
        check(err <= bar, f"{label}: BN-absorbed {n} differs by {err:.3e} "
                          f"of the largest gradient > {bar:g}")
    check(l2 <= l2_bar, f"{label}: gradient relative L2 {l2:.3e} > "
                        f"{l2_bar:.3e}")
    check(worst <= bar, f"{label}: gradient max-abs/scale {worst:.3e} > "
                        f"{bar:.3e} where no decision flipped")
    return (f"relative L2 {l2:.3e} (bar {l2_bar:.3e}), max-abs/scale "
            f"{worst:.3e} (bar {bar:.3e}) on the {len(free)} of "
            f"{len(g1) - len(absorbed)} tensors no flip reaches")


def _sf_step(d, cfg, clouds):
    """One slow/fast step on device ``d`` from the seed's weights: loss,
    gradients before Adam and decisions (``_sf_decisions``)."""
    from facl_tpu_torch.train import SlowFastTrainer
    tr = SlowFastTrainer(cfg, 100, device=d)
    st = tr.init_state(SEED)
    dec = {}
    with _sf_decisions(st.model, dec):
        st, m = tr.step_fn(st, clouds.to(d))
    return dict(loss=float(m["loss"]), dec=dec,
                grads={n: p.grad.detach().cpu() for n, p in
                       st.model.named_parameters()})


def _moco_f64(cfg, views, B):
    """The same MoCo step's loss and query gradients in float64 on the
    CPU, from the same weights and queue: the yardstick of how far float32
    itself moves this step."""
    from facl_tpu_torch.losses.infonce import cross_entropy
    from facl_tpu_torch.models.moco import moco_logits
    from facl_tpu_torch.train import MoCoTrainer
    from facl_tpu_torch.train.trainer import make_grouping_fn
    tr = MoCoTrainer(cfg, 100, queue_len=MOCO_QUEUE, device="cpu")
    st = tr.init_state(SEED, B)
    model, key = st.model.double().train(), st.moco.key_encoder.double()
    neigh, cent = make_grouping_fn(
        tr.cfg.grouping, "bcsk" if tr.cfg.model.channels_first else "bskc")(
        views)
    with torch.no_grad():
        k = key(neigh[1].double(), cent[1].double())[0]
    q = model(neigh[0].double(), cent[0].double())[0]
    loss = cross_entropy(*moco_logits(q, k, st.moco.queue.double()))
    loss.backward()
    return loss.item(), {n: p.grad.float() for n, p in
                         model.named_parameters() if p.grad is not None}


def _sf_f64(cfg, clouds):
    """The same slow/fast step's loss and gradients in float64 on the
    CPU, from the same weights."""
    from facl_tpu_torch.losses.infonce import cross_entropy, pair_infonce
    from facl_tpu_torch.ops.grouping import group_points
    from facl_tpu_torch.train import SlowFastTrainer
    model = SlowFastTrainer(cfg, 100, device="cpu").init_state(SEED).model
    model = model.double().train()
    model.dtype = torch.float64                # no cast of the inputs
    g = cfg.grouping
    slow, fast = (group_points(clouds, g.num_centroids, k, g.radius_sq)[0]
                  .double() for k in (SF_SLOW_K, SF_FAST_K))
    xf, xs = model(slow, fast)
    loss = cross_entropy(*pair_infonce(xf, xs, torch.cat([xf, xs])))
    loss.backward()
    return loss.item(), {n: p.grad.float() for n, p in
                         model.named_parameters()}


def _f32_floor(g64, g32, leave_out):
    """How far float32 itself sits from float64 on a step, over the
    gradients but ``leave_out``: (worst max-abs/scale, worst relative
    L2; 0 over none). Phase 6d holds the card at phase 3's bars or at
    twice this, whichever is larger: a step whose loss saturates (MoCo's,
    at temperature 1: its gradients carry the logits' absolute rounding
    as a relative error) or turns on a few decisions (slow/fast's) has
    an f32 floor above phase 3's bars on any device."""
    live = [n for n in g64 if n not in leave_out]
    if not live:
        return 0.0, 0.0
    return (max(float((g32[n] - g64[n]).abs().max()) /
                max(float(g64[n].abs().max()), 1e-30) for n in live),
            max(_rel_l2(g32[n], g64[n]) for n in live))


def _flips(a, b):
    return {n: int((a[n] != b[n]).sum()) for n in a}


def phase_moco_slowfast(dev, card: str, profile: bool = False):
    """MoCo and the slow/fast encoder at full width (module docstring,
    6d (a)-(d)). Returns {path: launches}."""
    from facl_tpu_torch.config import Config
    from facl_tpu_torch.train import MoCoTrainer, SlowFastTrainer
    here = os.path.dirname(os.path.abspath(__file__))
    kernels = all_kernels()
    out = {}
    g = torch.Generator().manual_seed(SEED + 40)
    N, C = 512, 4

    # (a) MoCo, B=64 a view, queue 9600: auto (bf16 pair3), pair3 f32 and
    # the shipped motion config as it is (bf16 reference).
    with open(os.path.join(here, CONFIGS["motion"][0])) as f:
        shipped = Config.from_json(f.read())
    views = torch.randn(2, 2, MOCO_B, N, C, generator=g).to(dev)
    for label, cfg in (("auto", _cfg(MOCO_B, "auto", dtype="bfloat16")),
                       ("pair3 f32", _cfg(MOCO_B, "pair3")),
                       ("shipped motion config", shipped)):
        tr = MoCoTrainer(cfg, 100, queue_len=MOCO_QUEUE, device=dev)
        st = tr.init_state(SEED, MOCO_B)
        m_cfg = tr.cfg.model
        st, per, launches, ms, peak = _timed(
            tr.step_fn, st, views, MOCO_WARM, MOCO_TIMED, kernels)
        want = _moco_want(m_cfg)
        check(launches == {k: v * MOCO_TIMED for k, v in want.items()},
              f"moco {label}: launches {launches}, expected {want} a step")
        check(st.moco.queue_ptr == ((MOCO_WARM + MOCO_TIMED) * MOCO_B) %
              MOCO_QUEUE, f"moco {label}: pointer {st.moco.queue_ptr}")
        med = statistics.median(per)
        name = f"moco {m_cfg.sa_impl} {m_cfg.compute_dtype} ({label})"
        out[name] = want
        if profile:
            _profile_once(lambda: tr.step_fn(st, views[0]),
                          f"{name} step on {card}")
        kread = _moco_kernels(dev, label, views[0], tr, st)
        print(f"{name} on {card}: B={MOCO_B} videos a view, N={N}, queue "
              f"{MOCO_QUEUE}: median {med:.2f} ms/step (min {per[0]:.2f}, "
              f"max {per[-1]:.2f}; {MOCO_TIMED} steps after {MOCO_WARM}), "
              f"{MOCO_B * 1e3 / med:.1f} clips/s, peak {peak:.2f} GiB; "
              f"launches a step {want}; losses {ms[0]['loss']:.4f} .. "
              f"{ms[-1]['loss']:.4f}; kernels at these shapes: {kread}",
              flush=True)
        del tr, st
        torch.cuda.empty_cache()
    del views

    # (b) MoCo, CPU against the card: pair3 f32 at B=8.
    cfg = _cfg(SMALL_B, "pair3")
    v = torch.randn(2, SMALL_B, N, C, generator=g)
    cpu, crd = (_moco_step(d, cfg, v, SMALL_B) for d in ("cpu", dev))
    check(math.isclose(crd["loss"], cpu["loss"], rel_tol=2e-4),
          f"moco cpu-vs-card loss {crd['loss']} vs {cpu['loss']}")
    check(torch.allclose(crd["queue"], cpu["queue"], rtol=2e-4, atol=1e-5),
          "moco cpu-vs-card: the queues differ")
    check(crd["ptr"] == cpu["ptr"] == SMALL_B, "moco cpu-vs-card: pointer")
    flips = {n: (cpu["dec"][n] != crd["dec"][n]).reshape(
        -1, cpu["dec"][n].shape[-1]) for n in cpu["dec"]}
    l64, g64 = _moco_f64(cfg, v, SMALL_B)
    top = max(float(t.abs().max()) for t in g64.values())
    floor, floor_l2 = _f32_floor(g64, cpu["grads"], {
        n for n, t in g64.items() if n.startswith(DP_ABSORBED) or
        float(t.abs().max()) <= 1e-6 * top})
    got = _dp_grad_bars("moco cpu-vs-card", cpu["grads"], crd["grads"],
                        flips, max(2e-4, 2 * floor))
    print(f"moco pair3 f32 cpu-vs-card, B={SMALL_B}, full width, on {card}: "
          f"loss {crd['loss']:.6f} vs {cpu['loss']:.6f} (rtol 2e-4; f64 "
          f"{l64:.6f}); queue within rtol 2e-4 / atol 1e-5, pointer "
          f"{crd['ptr']}; flipped decisions "
          f"{ {n: int(f.sum()) for n, f in flips.items()} }; the CPU's f32 "
          f"from f64: max-abs/scale {floor:.3e}, relative L2 "
          f"{floor_l2:.3e} (the max-abs bar: phase 3's 2e-4 or twice that "
          f"floor); gradients before Adam {got}", flush=True)
    del cpu, crd

    # (c) Slow/fast, G=10 x B=64 clouds, S=64, K=128 and 64.
    clouds = torch.randn(2, SF_G * SF_B, N, C, generator=g).to(dev)
    for dtype in ("float32", "bfloat16"):
        cfg = _sf_cfg(SF_B, dtype)
        tr = SlowFastTrainer(cfg, 100, device=dev)
        st = tr.init_state(SEED)
        st, per, launches, ms, peak = _timed(
            tr.step_fn, st, clouds, SF_WARM, SF_TIMED, kernels)
        check(launches == {"select_gather": 2 * SF_TIMED},
              f"slow_fast {dtype}: launches {launches}")
        med = statistics.median(per)
        out[f"slow_fast {dtype}"] = {"select_gather": 2}
        if profile:
            _profile_once(lambda: tr.step_fn(st, clouds[0]),
                          f"slow_fast {dtype} step on {card}")
        print(f"slow_fast {dtype} on {card}: {SF_G} x {SF_B} = "
              f"{SF_G * SF_B} clouds of N={N}, S={cfg.grouping.num_centroids},"
              f" K={SF_SLOW_K} and {SF_FAST_K}: median {med:.2f} ms/step "
              f"(min {per[0]:.2f}, max {per[-1]:.2f}; {SF_TIMED} steps after "
              f"{SF_WARM}), {SF_B * 1e3 / med:.1f} videos/s, peak "
              f"{peak:.2f} GiB; launches a step {{'select_gather': 2}}; "
              f"losses {ms[0]['loss']:.4f} .. {ms[-1]['loss']:.4f}",
              flush=True)
        del tr, st
        torch.cuda.empty_cache()
    gc_ = cfg.grouping
    for K in (SF_SLOW_K, SF_FAST_K):
        _b1_twin(clouds[0], gc_.num_centroids, K, gc_.radius_sq,
                 "slow_fast")
    print(f"slow_fast on {card}: B1 at K={SF_SLOW_K} and K={SF_FAST_K} over "
          f"the step's {SF_G * SF_B} clouds bit-equal to its twin",
          flush=True)
    del clouds
    torch.cuda.empty_cache()

    # (d) Slow/fast, CPU against the card: f32, G=10 x B=8 clouds.
    cfg = _sf_cfg(SMALL_B)
    c = torch.randn(SF_G * SMALL_B, N, C, generator=g)
    cpu, crd = (_sf_step(d, cfg, c) for d in ("cpu", dev))
    check(math.isclose(crd["loss"], cpu["loss"], rel_tol=2e-4),
          f"slow_fast cpu-vs-card loss {crd['loss']} vs {cpu['loss']}")
    flips = _flips(cpu["dec"], crd["dec"])
    l64, g64 = _sf_f64(cfg, c)
    got = _sf_grad_bars("slow_fast cpu-vs-card", cfg.model, cpu["grads"],
                        crd["grads"], flips, g64)
    print(f"slow_fast f32 cpu-vs-card, {SF_G * SMALL_B} clouds, full width, "
          f"on {card}: loss {crd['loss']:.6f} vs {cpu['loss']:.6f} (rtol "
          f"2e-4; f64 {l64:.6f}); flipped decisions {flips}; gradients "
          f"before Adam {got} (the bars: phase 3's, or twice the CPU's f32 "
          "distance from f64 on the same tensors where larger)", flush=True)
    return out


def moco_slowfast_clis(dev, card: str, tree: str, tmp: str):
    """(e): cli.moco and pretrain with a slow_fast config (a temp file;
    configs/ stays as it is) on phase 6c's generated tree, one epoch each
    at batch 16, with their launches; each checkpoint restored bit-equal
    to its file. Returns {path: launches}."""
    import argparse as ap
    from facl_tpu_torch.cli import moco, pretrain
    from facl_tpu_torch.train import MoCoTrainer, SlowFastTrainer, \
        latest_checkpoint, restore_checkpoint
    kernels = all_kernels()
    out = {}

    def restored(ck, target):
        path = latest_checkpoint(ck)
        saved = torch.load(path, map_location="cpu", weights_only=True)
        st = restore_checkpoint(path, target)
        for n, t in st.model.state_dict().items():
            check(torch.equal(t.cpu(), saved["model"][n]),
                  f"{ck}: {n} not restored bit-equal")
        return st, saved

    common = ["--root", tree, "--batch-size", "16", "--epochs", "1",
              "--device", str(dev)]
    cfg = pretrain.build_config(ap.Namespace(
        root=tree, stream="motion", dataset="ntu60", protocol="xview",
        batch_size=16, config=None, dtype="bfloat16", sa_impl=None))
    for k in kernels:
        k.launches = 0
    ck = os.path.join(tmp, "moco")
    t0 = time.perf_counter()
    hist = moco.main(common + ["--out", ck])
    dt = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels if k.launches}
    steps = launches.get("select_gather", 0)
    want = {k: v * steps for k, v in BF16_LAUNCHES["pair3 bf16"].items()}
    check(steps >= 1 and launches == want, f"cli.moco: launches {launches}")
    check(len(hist) == 1 and math.isfinite(hist[0]["loss"]),
          f"cli.moco: {hist}")
    st, saved = restored(ck, MoCoTrainer(cfg, 1, device=dev).init_state(1, 16))
    check(all(torch.equal(t.cpu(), saved["moco"]["key_encoder"][n]) for n, t
              in st.moco.key_encoder.state_dict().items()) and
          torch.equal(st.moco.queue.cpu(), saved["moco"]["queue"]) and
          st.moco.queue_ptr == saved["moco"]["queue_ptr"] == 16 * steps,
          "cli.moco: the MoCo state not restored bit-equal")
    out["cli.moco on the generated tree"] = launches
    print(f"cli.moco on the generated tree on {card}: batch 16, 1 epoch "
          f"({steps} steps) in {dt:.1f} s, loss {hist[0]['loss']:.4f}; "
          f"launches {launches}; checkpoint restored bit-equal (query, key, "
          f"queue, pointer {st.moco.queue_ptr})", flush=True)
    del st

    import dataclasses
    sf = cfg.replace(model=dataclasses.replace(cfg.model, name="slow_fast"))
    sf_file = os.path.join(tmp, "slow_fast.json")
    with open(sf_file, "w") as f:
        f.write(sf.to_json())
    for k in kernels:
        k.launches = 0
    ck = os.path.join(tmp, "slow_fast")
    t0 = time.perf_counter()
    hist = pretrain.main(common + ["--config", sf_file, "--out", ck])
    dt = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels if k.launches}
    check(set(launches) == {"select_gather"} and launches[
        "select_gather"] == 2 * steps, f"pretrain slow_fast: {launches}")
    check(len(hist) == 1 and math.isfinite(hist[0]["loss"]),
          f"pretrain slow_fast: {hist}")
    restored(ck, SlowFastTrainer(sf, 1, device=dev).init_state(1))
    out["pretrain slow_fast on the generated tree"] = launches
    print(f"pretrain slow_fast (bf16) on the generated tree on {card}: batch "
          f"16 x 10 crops, 1 epoch in {dt:.1f} s, loss {hist[0]['loss']:.4f};"
          f" launches {launches}; checkpoint restored bit-equal",
          flush=True)
    return out


# -- phase 7: data parallelism (B6s and the dp step) --------------------

#: (a)-(c): bench.py's batch, global; two gloo ranks time-share the card.
DP_B = 64
#: (d): the shipped multichip config, 2 warm-up and 5 timed steps.
DP_CONFIG = "configs/multichip_ntu120.json"
DP_WARM, DP_TIMED = 2, 5
#: (d)'s runs: (label, sa_impl forced or None for the config's, global B).
#: The config's own reference at B=128, not its 512: two reference ranks
#: at 256 a rank would need ~2 x 60 GiB (PERF.md section 4).
DP_TIMED_CASES = (("auto", "auto", 512), ("reference", None, 128))
#: (a), (b): the stage's and the step's cases (label, impl, dtype).
DP_STAGE_CASES = (("pair3", "pair3", "float32"),
                  ("pair3 bf16", "pair3", "bfloat16"),
                  ("pair", "pair", "float32"),
                  ("pair bf16", "pair", "bfloat16"))
DP_STEP_CASES = (("pair3", "pair3", "float32"),
                 ("pair3 bf16", "pair3", "bfloat16"),
                 ("pair bf16", "pair", "bfloat16"),
                 ("reference bf16", "reference", "bfloat16"))
#: Parameters whose exact gradient is zero (a BatchNorm follows).
DP_ABSORBED = ("sa_stage.bias_", "stage2_mlp.dense_0.bias",
               "stage2_mlp.dense_1.bias", "stage2_mlp.dense_2.bias",
               "head.Dense_0.bias")
DP_LAUNCHES = {"pair3": PATHS["pair3"], "pair": PATHS["pair"],
               **{label: BF16_LAUNCHES[label] for label in
                  ("pair3 bf16", "pair bf16", "reference bf16")}}


def _dp_counts():
    from facl_tpu_torch.parallel import COLLECTIVES, MP_COLLECTIVES
    return {c.__name__: c.calls for c in COLLECTIVES + MP_COLLECTIVES
            if c.calls}


def _dp_zero(kernels):
    from facl_tpu_torch.parallel import COLLECTIVES, MP_COLLECTIVES
    for c in COLLECTIVES + MP_COLLECTIVES + tuple(kernels):
        if hasattr(c, "calls"):
            c.calls = 0
        else:
            c.launches = 0


def _sync(dev, empty=False):
    """Wait for the card (and free its cache); nothing on the CPU, where
    the rank bodies are rehearsed."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
        if empty:
            torch.cuda.empty_cache()


def _dp_launches(kernels):
    return {k.__name__: k.launches for k in kernels if k.launches}


def _dp_inputs(dev, B, block):
    """The stage's input: randn points (10, B, 512, 4) from the seed,
    this block's clouds grouped by B1 (channel-major, batch-major rows),
    and a randn cotangent of the pooled rows."""
    from facl_tpu_torch.train.trainer import make_grouping_fn
    cfg = _cfg(B)
    g = torch.Generator().manual_seed(SEED + 11)
    pts = torch.randn(cfg.model.num_crops, B, cfg.data.num_points, 4,
                      generator=g)
    cot = torch.randn(B * cfg.model.num_crops, cfg.grouping.num_centroids,
                      cfg.model.sa_widths[-1], generator=g)
    with torch.no_grad():
        neigh, _ = make_grouping_fn(cfg.grouping, "bcsk")(
            pts[:, block].to(dev).transpose(0, 1))
    G = cfg.model.num_crops
    return (neigh.reshape(-1, *neigh.shape[2:]),
            cot[block.start * G:block.stop * G].to(dev))


def _dp_stage(dev, B, block, impl, dtype, mesh, drop=None):
    """One forward + backward of the SA stage alone on ``block``'s clouds:
    loss sum(pooled * cotangent), the cotangent zeroed at the (pool,
    channel) groups ``drop`` (P, C3) marks; returns statistics,
    gradients, the pool routing, the sweeps' launches and the B6s
    all-reduces."""
    from facl_tpu_torch.ops.fused_sa import SALayerParams
    from facl_tpu_torch.ops.sa_pair import sa_train_pair
    from facl_tpu_torch.parallel import psum
    from facl_tpu_torch.train import Trainer
    x_cf, cot = _dp_inputs(dev, B, block)
    if drop is not None:
        cot = cot.masked_fill(drop.to(dev).reshape(cot.shape), 0.0)
    stage = Trainer(_cfg(B), 100, device=dev).init_state(SEED).model.sa_stage
    ps = [SALayerParams(*(t.detach().clone().requires_grad_() for t in lp))
          for lp in stage.layers()]
    kernels = all_kernels()
    _dp_zero(kernels)
    routes = []
    with sa_routing(routes, impl):
        pooled, stats = sa_train_pair(
            x_cf, ps, 1e-5, slim=impl == "pair3", mesh=mesh,
            dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    fwd = psum.calls
    (pooled.float() * cot).sum().backward()
    _sync(dev)
    return dict(stats=[(m.cpu(), v.cpu()) for m, v in stats],
                grads=[[t.grad.cpu() for t in lp] for lp in ps],
                route=routes[0], launches=_dp_launches(kernels),
                psum=(fwd, psum.calls - fwd))


def _dp_stage_rank(devtype, B, routes):
    """(a) on one rank: each stage case on this rank's block; for the
    cases in ``routes`` (the one process's pool routing, (P, C3) over the
    global batch) the same again with the cotangent zeroed at the groups
    whose routing this rank flipped (``masked``: its gradients); then
    each case with the B6s all-reduces timed (``_timed_collectives``)."""
    from facl_tpu_torch.parallel import batch_slice, make_mesh, rank_device
    mesh = make_mesh()
    dev = rank_device(devtype)
    block = batch_slice(mesh, B)
    out = {}
    for label, impl, dtype in DP_STAGE_CASES:
        r = out[label] = _dp_stage(dev, B, block, impl, dtype, mesh)
        if label in routes:
            P = r["route"].shape[0]
            one = routes[label][mesh.rank * P:(mesh.rank + 1) * P]
            r["masked"] = _dp_stage(dev, B, block, impl, dtype, mesh,
                                    drop=r["route"] != one)["grads"]
    for label, impl, dtype in DP_STAGE_CASES:
        acc = {}
        with _timed_collectives(acc, dev):
            _dp_stage(dev, B, batch_slice(mesh, B), impl, dtype, mesh)
        out[label]["b6s"] = acc.get("psum (B6s)")
    out["gloo"] = _gloo_cuda_ops(dev, mesh)
    out["latency"] = _b6s_latency(dev, mesh)
    return out


#: Element counts of pair3's six B6s buffers (float64): Gram(x) and
#: colsum(x); the sums of p2 and p2^2; Gram(h2) and colsum(h2); A3 and
#: u3; A2, G1, u2 and ch1; A1 and u1.
B6S_SIZES = (4 * 4 + 4, 2 * 64, 64 * 64 + 64, 256 * 64 + 256,
             2 * 64 * 64 + 2 * 64, 64 * 4 + 64)


def _b6s_latency(dev, mesh, reps: int = 20):
    """Mean ms of one all_reduce of each B6s buffer size between ranks
    that do nothing else (after a barrier), on ``dev``."""
    import torch.distributed as dist
    out = {}
    for n in B6S_SIZES:
        t = torch.ones(n, dtype=torch.float64, device=dev)
        dist.all_reduce(t)
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            dist.all_reduce(t)
        _sync(dev)
        out[n] = (time.perf_counter() - t0) * 1e3 / reps
    return out


def _gloo_cuda_ops(dev, mesh):
    """Which collectives this backend takes on ``dev`` tensors."""
    import torch.distributed as dist
    ops = {"all_reduce": lambda t: dist.all_reduce(t),
           "broadcast": lambda t: dist.broadcast(t, 0),
           "all_gather": lambda t: dist.all_gather(
               [torch.empty_like(t) for _ in range(mesh.dp)], t),
           "all_gather_into_tensor": lambda t: dist.all_gather_into_tensor(
               torch.empty(mesh.dp * t.numel(), device=dev), t)}
    out = {}
    for name, op in ops.items():
        try:
            op(torch.ones(4, device=dev))
            out[name] = "ok"
        except (RuntimeError, ValueError) as e:
            out[name] = str(e).splitlines()[0][:80]
    return out


def _pack(dec):
    """Decisions as packed bits (they cross the process boundary)."""
    import numpy as np
    return {n: (tuple(t.shape), t.dtype == torch.bool,
                np.packbits(t.numpy().ravel()) if t.dtype == torch.bool
                else t.numpy()) for n, t in dec.items()}


def _unpack(packed):
    import numpy as np
    out = {}
    for n, (shape, is_bool, a) in packed.items():
        if is_bool:
            size = math.prod(shape)
            a = np.unpackbits(a)[:size].astype(bool)
        out[n] = torch.from_numpy(np.asarray(a).reshape(shape))
    return out


def _dp_step_rank(devtype, B, steps):
    """(b) on one rank: for each step case, the Trainer from the seed's
    weights (rank 0's, broadcast) on this rank's block of randn points:
    the first step's loss, gradients before Adam, BatchNorm buffers,
    decisions, kernel launches and collectives; the parameters after
    ``steps`` steps."""
    from facl_tpu_torch.parallel import batch_slice, make_mesh, \
        rank_device, shard_train_state
    from facl_tpu_torch.train import Trainer
    mesh = make_mesh()
    dev = rank_device(devtype)
    pts, perm = _dp_points(B)
    local = pts[:, batch_slice(mesh, B)].to(dev)
    kernels = all_kernels()
    out = {}
    for label, impl, dtype in DP_STEP_CASES:
        tr = Trainer(_cfg(B, impl, dtype=dtype), 100, device=dev, mesh=mesh)
        st = shard_train_state(mesh, tr.init_state(SEED))
        _dp_zero(kernels)
        dec = {}
        with _decisions(st.model, impl, B // mesh.dp, dec):
            st, m = tr.step_fn(st, local, perm=perm)
        _sync(dev)
        res = dict(loss=float(m["loss"]), counts=_dp_counts(),
                   launches=_dp_launches(kernels), dec=_pack(dec),
                   grads={n: p.grad.cpu() for n, p in
                          st.model.named_parameters() if p.grad is not None},
                   buffers={n: b.cpu().clone() for n, b in
                            st.model.named_buffers()})
        for _ in range(steps - 1):
            st, _ = tr.step_fn(st, local, perm=perm)
        res["params_end"] = {n: p.detach().cpu() for n, p in
                             st.model.named_parameters()}
        out[label] = res
        del tr, st
        _sync(dev, empty=True)
    return out


def _dp_points(B):
    """(b), (c): randn points (G, B, N, 4) and a crop permutation."""
    cfg = _cfg(B)
    G = cfg.model.num_crops
    g = torch.Generator().manual_seed(SEED + 12)
    return (torch.randn(G, B, cfg.data.num_points, 4, generator=g),
            torch.randperm(G, generator=g))


def _dp_one_step(dev, B, impl, dtype, witness=None):
    """The one-process step of (b) on the same points and weights. With
    ``witness``, the same step in another rounding (no decisions
    recorded): "swap", the batch's two halves swapped (every sum over
    the clips in another order; exact arithmetic gives the same loss,
    gradients and statistics); "halves", the rounding two ranks give it
    (tests/torch_two_halves.py::as_two_halves); "columns", the rounding
    two mp ranks give it (as_column_blocks: each split Dense as two
    column-block GEMMs). Also the bytes of its parameters and Adam
    state after the step."""
    from facl_tpu_torch.train import Trainer
    pts, perm = _dp_points(B)
    if witness == "swap":
        pts = torch.cat([pts[:, B // 2:], pts[:, :B // 2]], 1)
    tr = Trainer(_cfg(B, impl, dtype=dtype), 100, device=dev)
    st = tr.init_state(SEED)
    dec = {}
    with contextlib.ExitStack() as stack:
        if witness is None:
            stack.enter_context(_decisions(st.model, impl, B, dec))
        elif witness == "halves":
            stack.enter_context(_as_two_halves())
        elif witness == "columns":
            stack.enter_context(_witnesses().as_column_blocks(2))
        st, m = tr.step_fn(st, pts.to(dev), perm=perm)
    return dict(loss=float(m["loss"]), dec=dec, bytes=_state_bytes(st),
                grads={n: p.grad.cpu() for n, p in
                       st.model.named_parameters() if p.grad is not None},
                buffers={n: b.cpu().clone() for n, b in
                         st.model.named_buffers()})


_WITNESSES = []


def _witnesses():
    """tests/torch_two_halves.py, loaded from this checkout's file (once):
    the checkout's tests/ has no __init__.py, so a package named
    ``tests`` installed on the machine would shadow it."""
    if not _WITNESSES:
        here = os.path.dirname(os.path.abspath(__file__))
        path = os.path.join(here, "tests", "torch_two_halves.py")
        spec = importlib.util.spec_from_file_location("torch_two_halves",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _WITNESSES.append(mod)
    return _WITNESSES[0]


def _as_two_halves():
    """tests/torch_two_halves.py::as_two_halves (``_witnesses``)."""
    return _witnesses().as_two_halves()


def _state_bytes(st):
    """Bytes of a state's parameters plus Adam's state tensors, as this
    process holds them."""
    n = sum(p.numel() * p.element_size() for p in st.model.parameters())
    return n + sum(t.numel() * t.element_size() for per in
                   st.optimizer.state.values() for t in per.values()
                   if isinstance(t, torch.Tensor))


def _merge_decisions(ranks, B, G):
    """The ranks' decisions in the one process's row order: every record
    is batch-major, so the ranks' blocks concatenate, but for the head's
    two calls (local rows, then the videos)."""
    decs = [_unpack(r) for r in ranks]
    Bl = B // len(decs)
    out = {}
    for n in decs[0]:
        if n == "head.0":
            out[n] = torch.cat([d[n][:Bl * G] for d in decs] +
                               [d[n][Bl * G:] for d in decs])
        else:
            out[n] = torch.cat([d[n] for d in decs])
    return out


def _dp_stage_grads(dev, B, label, impl, one, r0, r1, route):
    """(a) in f32: the ranks' gradients against the one process's, at
    relative L2 1e-2 as they are, and at max-abs 2e-4 of each tensor's
    scale with the cotangent zeroed at every (pool, channel) group whose
    pool routing flipped, in both runs (each rank at its own flips, the
    one process at all of them), so that no flipped pool decision reaches
    any gradient. The biases are BN-absorbed (exact gradient zero): left
    out. Returns the reading."""
    def live(grads):
        return [t for lp in grads for k, t in enumerate(lp) if k != 1]
    l2 = max(_rel_l2(a, w) for a, w in zip(live(r0["grads"]),
                                           live(one["grads"])))
    check(l2 <= 1e-2, f"dp (a) {label}: relative L2 {l2:.3e}")
    check(all(torch.equal(a, b) for a, b in zip(live(r0["masked"]),
                                                live(r1["masked"]))),
          f"dp (a) {label}: masked gradients differ between the ranks")
    drop = route != one["route"]
    held = live(_dp_stage(dev, B, slice(0, B), impl, "float32", None,
                          drop=drop)["grads"])
    worst = max(float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for a, w in zip(live(r0["masked"]), held))
    check(worst <= 2e-4, f"dp (a) {label}: max-abs/scale {worst:.3e} > 2e-4 "
                         "with the flipped groups' cotangent zeroed")
    return (f"statistics within rtol 1e-5/1e-4; gradients relative L2 "
            f"{l2:.3e} (bar 1e-2); with the cotangent zeroed at the "
            f"{int(drop.sum())} flipped (pool, channel) groups, max-abs/"
            f"scale {worst:.3e} (bar 2e-4) over all "
            f"{sum(t.numel() for t in held)} live gradient entries")


def _dp_grad_bars(label, g1, gk, flips, bar):
    """Relative L2 at most 1e-2 on every gradient, max-abs at most
    ``bar`` of its scale where no flipped decision reaches (``_touched``;
    the SA stage's internal masks are not observed: its gradients by L2
    alone), the BN-absorbed biases at ``bar`` of the largest gradient.
    Returns (worst L2, worst max-abs, entries held)."""
    n2 = sum(1 for n in flips if n.startswith("stage2_mlp."))
    top = max(float(t.abs().max()) for t in g1.values())
    # BN-absorbed by name, and the gradients cancelled to round-off by a
    # BatchNorm downstream (the last stage-2 shift: a constant shift of
    # every row survives the pools and dies in the head's BatchNorm).
    absorbed = {n for n, t in g1.items() if n.startswith(DP_ABSORBED) or
                float(t.abs().max()) <= 1e-6 * top}
    touched = _touched(g1, {n: f.any(0) for n, f in flips.items()}, n2)
    l2, free, n_free, _ = _compare(g1, gk, touched, absorbed)
    for n in absorbed:
        err = float((gk[n] - g1[n]).abs().max()) / top
        check(err <= bar, f"dp {label}: BN-absorbed {n} differs by {err:.3e} "
                          f"of the largest gradient > {bar:g}")
    check(l2 <= 1e-2, f"dp {label}: gradient relative L2 {l2:.3e} > 1e-2")
    check(free <= bar, f"dp {label}: gradient max-abs/scale {free:.3e} > "
                       f"{bar:g} where no decision flipped")
    return (f"relative L2 {l2:.3e}, max-abs/scale {free:.3e} (bar {bar:g}) "
            f"on the {n_free} entries no flip reaches")


def _in_bars(got, ref, rtol, atol):
    """max |got - ref| / (atol + rtol |ref|): at most 1 within the bars
    of ``torch.allclose``."""
    return float(((got - ref).abs() / (atol + rtol * ref.abs())).max())


def _f32_dist(ref, got):
    """Relative L2 of the tensors ``got`` from ``ref``, all together."""
    num = sum(float((g.double() - r.double()).norm()) ** 2
              for r, g in zip(ref, got))
    return (num / sum(float(r.double().norm()) ** 2 for r in ref)) ** 0.5


def _dp_vs_f32(label, what, ref, one, dp):
    """bf16: two bf16 runs that round in other orders put thousands of
    decisions on other sides (phase 3's bf16 step says why): no f32 bar
    holds between them. As phase 3 does, each is held against a run of
    higher precision, the one-process f32 run on the same card: the two
    ranks' distance from it at most twice the one process's. Returns the
    reading."""
    e_one, e_dp = _f32_dist(ref, one), _f32_dist(ref, dp)
    check(e_dp <= 2 * e_one, f"dp {label}: {what} {e_dp:.3e} from the f32 "
                             f"run, one process {e_one:.3e}")
    return f"{what} from the f32 run: two ranks {e_dp:.3e}, one {e_one:.3e}"


def _dp_bf16_stage(label, f32, one, dp):
    """(a) at bf16: each statistic within 1e-3 of its max-abs of the
    one-process bf16 stage's (``acc_rel``'s bar for the bf16 sweeps' f32
    accumulators, whence they come: f32's rtol 1e-5 is below the flips
    of bf16 roundings that two summation orders leave); statistics and
    the live gradients against the f32 stage (``_dp_vs_f32``)."""
    def stats(r):
        return [t for mv in r["stats"] for t in mv]

    def grads(r):
        return [t for lp in r["grads"] for k, t in enumerate(lp) if k != 1]
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(stats(dp), stats(one)))
    check(worst <= 1e-3, f"dp (a) {label}: statistics {worst:.3e} of their "
                         "max-abs from one process's bf16 stage > 1e-3")
    f32_bars = [round(max(_in_bars(m, m1, 1e-5, 1e-6),
                          _in_bars(v, v1, 1e-4, 1e-6)), 3)
                for (m, v), (m1, v1) in zip(dp["stats"], one["stats"])]
    return f"statistics {worst:.3e} of their max-abs from one process's " \
        f"(bar 1e-3; f32's rtol 1e-5 / 1e-4 would read {f32_bars} of " \
        "their bar by layer); " + "; ".join(
            _dp_vs_f32(f"(a) {label}", what, f(f32), f(one), f(dp))
            for what, f in (("statistics", stats), ("gradients", grads)))


#: The witnesses of ``_dp_bf16_step``: one process rounding as the ranks
#: of a dp mesh ("halves") or of an mp mesh ("columns") do.
WITNESS_TEXT = {"halves": "one process as two halves",
                "columns": "one process as two column blocks"}


def _dp_bf16_step(label, f32, one, dp, witnesses, wname="halves",
                  phase="(b)"):
    """(b) at bf16: the loss, the running statistics and the live
    gradients (not BN-absorbed) against the f32 step (``_dp_vs_f32``);
    the loss at rtol 2e-3 (about half a bf16 ulp, 2^-9) of the
    one-process bf16 step's; and the loss and running statistics at the
    f32 bars (rtol 2e-4; rtol 1e-3 / atol 1e-5) of the one process
    rounding as the ranks do (``witnesses[wname]``: "halves",
    tests/torch_two_halves.py: every sum the ranks split, the pair stage's
    B6s all-reduces included; "columns", each split Dense as column-block
    GEMMs), their differences printed (zero where the witness is bit for
    bit). Beside
    them, how far the two ranks and each of the ``witnesses``
    (``_dp_one_step``) sit from the one-process bf16 step (loss;
    gradients and running statistics by relative L2, together), the
    running statistics' worst max-abs of their scale, and each
    gradient's two-rank relative L2 at its worst."""
    g32 = f32["grads"]
    top = max(float(t.abs().max()) for t in g32.values())
    live = [n for n, t in g32.items() if not n.startswith(DP_ABSORBED) and
            float(t.abs().max()) > 1e-6 * top]
    bufs = sorted(f32["buffers"])
    out = [_dp_vs_f32(f"{phase} {label}", what, [r[k] for k in keys],
                      [o[k] for k in keys], [d[k] for k in keys])
           for what, keys, r, o, d in (
               ("loss", ["loss"], *({"loss": torch.tensor(x["loss"])}
                                    for x in (f32, one, dp))),
               ("running statistics", bufs, f32["buffers"], one["buffers"],
                dp["buffers"]),
               ("gradients", live, g32, one["grads"], dp["grads"]))]
    rel = abs(dp["loss"] - one["loss"]) / abs(one["loss"])
    check(rel <= 2e-3, f"dp {phase} {label}: loss {dp['loss']} vs one process "
                       f"{one['loss']} beyond rtol 2e-3")
    halves, wtext = witnesses[wname], WITNESS_TEXT[wname]
    check(math.isclose(dp["loss"], halves["loss"], rel_tol=2e-4),
          f"dp {phase} {label}: loss {dp['loss']} vs {wtext} {halves['loss']}")
    in_bar = {n: _in_bars(dp["buffers"][n], halves["buffers"][n], 1e-3, 1e-5)
              for n in bufs}
    bad = {n: round(v, 3) for n, v in in_bar.items() if v > 1.0}
    check(not bad, f"dp {phase} {label}: running statistics beyond rtol 1e-3"
                   f" / atol 1e-5 of {wtext}, in units of the bar: {bad}")
    same = sum(torch.equal(dp["buffers"][n], halves["buffers"][n])
               for n in bufs)
    exact = (f"loss {abs(dp['loss'] - halves['loss']):.3e} apart, running "
             f"statistics worst {max(in_bar.values()):.3e} of the bar, "
             f"{same} of {len(bufs)} bit-equal")
    rs = {n: float((dp["buffers"][n] - one["buffers"][n]).abs().max()) /
          max(float(one["buffers"][n].abs().max()), 1e-30) for n in bufs}
    rs_worst = max(rs, key=rs.get)
    rb = {n: _in_bars(dp["buffers"][n], one["buffers"][n], 1e-3, 1e-5)
          for n in bufs}
    rb_worst = max(rb, key=rb.get)

    def gap(r, ref=one):
        loss = abs(r["loss"] - ref["loss"]) / abs(ref["loss"])
        g = _f32_dist([ref["grads"][n] for n in live],
                      [r["grads"][n] for n in live])
        b = _f32_dist([ref["buffers"][n] for n in bufs],
                      [r["buffers"][n] for n in bufs])
        return (f"loss {loss:.3e}, gradients {g:.3e}, running statistics "
                f"{b:.3e}")
    l2 = {n: _rel_l2(dp["grads"][n], one["grads"][n]) for n in live}
    worst = max(l2, key=l2.get)
    return "; ".join(out) + (
        "; loss within rtol 2e-3 of one process's; loss and running "
        f"statistics within the f32 bars of {wtext} ({exact})" +
        f"; running statistics from one process's worst max-abs/scale "
        f"{rs[rs_worst]:.3e} ({rs_worst}), {rb[rb_worst]:.3f} of f32's rtol "
        f"1e-3 / atol 1e-5 ({rb_worst}); from the one-process bf16 step: "
        f"two ranks {gap(dp)}; " + "; ".join(
            f"one process {w} {gap(r)}" for w, r in witnesses.items()) +
        f"; two ranks from {wtext}: {gap(dp, halves)}"
        f"; gradients two ranks vs one process worst relative L2 "
        f"{l2[worst]:.3e} ({worst})")


def _dp_nccl_rank(devtype, B):
    """(c): the dp pair3 step over NCCL at world size 1: its loss, its
    collectives and launches."""
    from facl_tpu_torch.parallel import make_mesh, rank_device, \
        shard_train_state
    from facl_tpu_torch.train import Trainer
    import torch.distributed as dist
    mesh = make_mesh()
    dev = rank_device(devtype)
    pts, perm = _dp_points(B)
    tr = Trainer(_cfg(B), 100, device=dev, mesh=mesh)
    st = shard_train_state(mesh, tr.init_state(SEED))
    kernels = all_kernels()
    _dp_zero(kernels)
    st, m = tr.step_fn(st, pts.to(dev), perm=perm)
    _sync(dev)
    return dict(backend=dist.get_backend(), dp=mesh.dp, loss=float(m["loss"]),
                counts=_dp_counts(), launches=_dp_launches(kernels))


@contextlib.contextmanager
def _timed_collectives(acc: dict, dev):
    """Time every all_reduce and broadcast of the collectives module on
    the host, the device synchronised before and after, into ``acc``
    ({kind: [ms, bytes, calls]}) by the collective that issued it."""
    import torch.distributed as dist
    from facl_tpu_torch.parallel import collectives as C
    names = {"psum": "psum (B6s)", "_slots": "gathers",
             "forward": "BN moments", "backward": "BN moments",
             "psum_grads": "gradient sum", "cross_replica_mean": "other"}
    reduce0, bcast0 = C._all_reduce, dist.broadcast
    mp_reduce0, mp_gather0 = C._mp_all_reduce, C._mp_all_gather

    def timed(fn, label):
        def wrapped(*a, **k):
            _sync(dev)
            t0 = time.perf_counter()
            r = fn(*a, **k)
            _sync(dev)
            key = label or names.get(sys._getframe(1).f_code.co_name,
                                     "other")
            rec = acc.setdefault(key, [0.0, 0, 0])
            rec[0] += (time.perf_counter() - t0) * 1e3
            rec[1] += a[0].numel() * a[0].element_size()
            rec[2] += 1
            return r
        return wrapped
    C._all_reduce = timed(reduce0, None)
    dist.broadcast = timed(bcast0, "broadcast")
    # Tensor parallelism: the bytes are each rank's own tensor.
    C._mp_all_reduce = timed(mp_reduce0, "mp input sums")
    C._mp_all_gather = timed(mp_gather0, "mp gathers")
    try:
        yield
    finally:
        C._all_reduce, dist.broadcast = reduce0, bcast0
        C._mp_all_reduce, C._mp_all_gather = mp_reduce0, mp_gather0


def _dp_time_rank(devtype, cfg_path, impl, B, warm, timed):
    """(d) on one rank: the config at global batch B (``impl`` forced, or
    as shipped), ``warm`` steps, then ``timed`` steps timed by CUDA events
    between steps, then ``timed`` more with each collective timed on the
    host (``_timed_collectives``: it synchronises, so these steps are not
    the timed ones). Returns ms per step, collective ms per step by kind,
    the peak allocation, the losses and one step's collectives."""
    import dataclasses
    from facl_tpu_torch.config import Config
    from facl_tpu_torch.parallel import make_mesh, rank_device, \
        shard_train_state
    from facl_tpu_torch.train import Trainer
    mesh = make_mesh()
    dev = rank_device(devtype)
    with open(cfg_path) as f:
        cfg = Config.from_json(f.read())
    model = cfg.model if impl is None else dataclasses.replace(
        cfg.model, sa_impl=impl, channels_first=None)
    cfg = cfg.replace(model=model, train=dataclasses.replace(
        cfg.train, batch_size=B))
    tr = Trainer(cfg, 100, device=dev, mesh=mesh)
    st = shard_train_state(mesh, tr.init_state(SEED))
    g = torch.Generator(device=dev).manual_seed(SEED + 20 + mesh.rank)
    pts = torch.randn(cfg.model.num_crops, B // mesh.dp, cfg.data.num_points,
                      4, generator=g, device=dev)
    perm_gen = torch.Generator().manual_seed(SEED)
    for _ in range(warm):
        st, _ = tr.step_fn(st, pts, generator=perm_gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = all_kernels()
    _dp_zero(kernels)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    losses = []
    ev[0].record()
    for i in range(timed):
        st, m = tr.step_fn(st, pts, generator=perm_gen)
        ev[i + 1].record()
        losses.append(m["loss"])
    torch.cuda.synchronize()
    counts, launches = _dp_counts(), _dp_launches(kernels)
    acc = {}
    with _timed_collectives(acc, dev):
        for _ in range(timed):
            st, m = tr.step_fn(st, pts, generator=perm_gen)
    torch.cuda.synchronize()
    inputs = None
    if mesh.rank == 0:
        inputs = dict(pts=pts.cpu(), grouping=tr.cfg.grouping,
                      sa=[tuple(t.detach().cpu() for t in lp)
                          for lp in st.model.sa_stage.layers()])
    return dict(ms=[ev[i].elapsed_time(ev[i + 1]) for i in range(timed)],
                coll={k: [v[0] / timed, v[1] // timed, v[2] // timed]
                      for k, v in acc.items()},
                peak=torch.cuda.max_memory_allocated(dev) / 2**30,
                losses=[float(v) for v in losses],
                counts={k: v // timed for k, v in counts.items()},
                launches={k: v // timed for k, v in launches.items()},
                impl=tr.cfg.model.sa_impl, dtype=tr.cfg.model.compute_dtype,
                model=tr.cfg.model, inputs=inputs)


def _dp_kernels(dev, card, label, r0):
    """(d): the run's kernels against their twins at the size the run
    gives them, on rank 0's own points (its B/2 clouds), with its SA
    weights after the timed steps and a randn cotangent: B1 bit-equal to
    its twin (phase 2's B1 bar), and where the run launched the bf16
    sweeps, the five at phase 2's bf16 bars on B1's grouping
    (``bf16_rows``)."""
    from facl_tpu_torch.ops.fused_sa import SALayerParams
    from facl_tpu_torch.train.trainer import make_grouping_fn
    inp = r0["inputs"]
    g_cfg, pts = inp["grouping"], inp["pts"].to(dev)
    G, Bl, N, C = pts.shape
    S, K, r2 = g_cfg.num_centroids, g_cfg.knn_k, g_cfg.radius_sq
    flat = pts.transpose(0, 1).reshape(Bl * G, N, C).contiguous()
    _b1_twin(flat, S, K, r2, f"dp (d) {label}")
    del flat
    sweeps = "sa_fwd_layer12_bf16" in r0["launches"]
    if sweeps:
        with torch.no_grad():
            neigh, _ = make_grouping_fn(g_cfg, "bcsk")(pts.transpose(0, 1))
        x3 = neigh.reshape(Bl * G, C, S * K)
        del neigh, pts
        layers = [SALayerParams(*(t.to(dev) for t in lp)) for lp in inp["sa"]]
        g = torch.Generator().manual_seed(SEED + 21)
        dpooled = torch.randn(Bl * G * S, layers[-1].kernel.shape[1],
                              generator=g).to(dev)
        _sync(dev, empty=True)
        bf16_rows(x3, layers, dpooled, K)
        del x3, dpooled
    _sync(dev, empty=True)
    print(f"dp (d) {label}: rank 0's inputs ({Bl * G} clouds) on {card}: B1 "
          f"bit-equal to its twin" + (
              f"; the five bf16 sweeps at R={Bl * G * S * K} within phase 2's "
              "bf16 bars (line above)" if sweeps else ""), flush=True)


def _dp_want_counts(model_cfg, impl):
    """Collectives of one dp step: the B6s sums of pair/pair3 and
    analytic's backward sums (one a SA layer), the BatchNorm moment sums
    (stage-2's layers and the head's, called twice, and the reference and
    covar SA's, but for covar's first Gram, of the input; analytic's
    forward only), forward and backward; two gathers, the permutation's
    broadcast and one gradient sum."""
    L = len(model_cfg.sa_widths)
    sa = {"reference": 2 * L, "covar": 2 * L - 1, "analytic": L}.get(impl,
                                                                      0)
    want = {"global_moments": 2 * (len(model_cfg.stage2_widths) + 2) + sa,
            "gather_negatives": 2, "broadcast": 1, "psum_grads": 1}
    psum = {"pair3": 6, "pair": 5, "analytic": L}.get(impl, 0)
    if psum:
        want["psum"] = psum
    return want


def phase_dp(dev, card: str):
    """Phase 7: data parallelism on the card (module docstring); returns
    {path: launches} of each rank's paths."""
    from facl_tpu_torch.parallel import spawn
    here = os.path.dirname(os.path.abspath(__file__))
    B = DP_B
    out = {}
    _sync(dev, empty=True)

    # (a) The sharded stage: two gloo ranks on this card against one
    # process on the same card tensors. The one process runs first: its
    # f32 pool routing goes to the ranks, which rerun with the cotangent
    # zeroed where theirs differs.
    ones = {label: _dp_stage(dev, B, slice(0, B), impl, dtype, None)
            for label, impl, dtype in DP_STAGE_CASES}
    _sync(dev, empty=True)
    t0 = time.perf_counter()
    ranks = spawn(_dp_stage_rank, 2, "gloo",
                  args=(dev.type, B, {label: ones[label]["route"] for
                                      label, _, dtype in DP_STAGE_CASES
                                      if dtype == "float32"}),
                  timeout_s=600)
    print(f"dp (a): two gloo ranks on {card} in {time.perf_counter() - t0:.1f}"
          f" s; gloo on CUDA tensors: {ranks[0]['gloo']}", flush=True)
    for label, impl, dtype in DP_STAGE_CASES:
        one = ones[label]
        r0, r1 = ranks[0][label], ranks[1][label]
        want = {k: v for k, v in DP_LAUNCHES[label].items()
                if k != "select_gather"}
        for r in (r0, r1):
            check(r["launches"] == want, f"dp (a) {label}: launches "
                                         f"{r['launches']}, expected {want}")
            check(r["psum"] == (3, 3 if impl == "pair3" else 2),
                  f"dp (a) {label}: B6s all-reduces {r['psum']}")
        for i, (l0, l1) in enumerate(zip(r0["grads"], r1["grads"])):
            check(all(torch.equal(a, b) for a, b in zip(l0, l1)),
                  f"dp (a) {label}: layer {i}'s gradients differ between "
                  "the ranks")
        route = torch.cat([r0["route"], r1["route"]])
        flips = int((route != one["route"]).sum())
        if dtype == "bfloat16":
            got = _dp_bf16_stage(label, ones[impl], one, r0)
        else:
            stats = [max(_in_bars(ms, m1, 1e-5, 1e-6),
                         _in_bars(vs, v1, 1e-4, 1e-6))
                     for (ms, vs), (m1, v1) in zip(r0["stats"], one["stats"])]
            check(max(stats) <= 1.0, f"dp (a) {label}: statistics beyond "
                                     f"rtol 1e-5 / 1e-4 of one process's, by "
                                     f"layer, in units of the bar: {stats}")
            got = _dp_stage_grads(dev, B, label, impl, one, r0, r1, route)
        out[f"dp (a) {label} stage, per rank"] = r0["launches"]
        print(f"dp (a) {label} stage, B={B} ({B // 2} a rank), two ranks vs "
              f"one process on {card}: {got}; gradients equal on both "
              f"ranks; pool routing flipped at {flips} of {route.numel()} "
              f"indices; B6s all-reduces a rank {r0['psum'][0]} + "
              f"{r0['psum'][1]}, {r0['b6s'][1]} bytes, {r0['b6s'][0]:.3f} ms "
              f"on the host in the stage (synchronised; waits for the other "
              f"rank included; rank 1: {r1['b6s'][0]:.3f}); launches a rank "
              f"{r0['launches']}", flush=True)
    lat = ranks[0]["latency"]
    print(f"dp (a) gloo all_reduce of CUDA float64 buffers between two idle "
          f"ranks on {card}, ms a call (mean of 20) by element count: "
          f"{ {n: round(v, 4) for n, v in lat.items()} }; the six B6s "
          f"all-reduces of a pair3 step: {sum(lat.values()):.3f} ms",
          flush=True)

    # (b) The train step: two gloo ranks against one process.
    t0 = time.perf_counter()
    ranks = spawn(_dp_step_rank, 2, "gloo", args=(dev.type, B, 3),
                  timeout_s=600)
    print(f"dp (b): two gloo ranks, {len(DP_STEP_CASES)} configs x 3 steps, "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    losses = {}
    for label, impl, dtype in DP_STEP_CASES:
        one = _dp_one_step(dev, B, impl, dtype)
        _sync(dev, empty=True)
        r0, r1 = ranks[0][label], ranks[1][label]
        losses[label] = one["loss"]
        check(r0["loss"] == r1["loss"], f"dp (b) {label}: the ranks' losses "
                                         f"{r0['loss']} {r1['loss']}")
        if dtype == "float32":
            check(math.isclose(r0["loss"], one["loss"], rel_tol=2e-4),
                  f"dp (b) {label}: loss {r0['loss']} vs one process "
                  f"{one['loss']}")
            for n, w in one["buffers"].items():
                check(torch.allclose(r0["buffers"][n], w, rtol=1e-3,
                                     atol=1e-5),
                      f"dp (b) {label}: running statistic {n}")
        for n, p in r0["params_end"].items():
            check(torch.equal(p, r1["params_end"][n]),
                  f"dp (b) {label}: {n} differs between the ranks after 3 "
                  "steps")
        for n, gr in r0["grads"].items():
            check(torch.equal(gr, r1["grads"][n]),
                  f"dp (b) {label}: gradient {n} differs between the ranks")
        dk = _merge_decisions([r0["dec"], r1["dec"]], B,
                              _cfg(B).model.num_crops)
        flips = {n: (one["dec"][n] != dk[n]).reshape(
            -1, one["dec"][n].shape[-1]) for n in one["dec"]}
        if dtype == "bfloat16":
            f32 = _dp_one_step(dev, B, impl, "float32")
            wit = {w: _dp_one_step(dev, B, impl, dtype, w)
                   for w in ("swap", "halves")}
            _sync(dev, empty=True)
            got = _dp_bf16_step(label, f32, one, r0, wit)
        else:
            got = ("loss within rtol 2e-4, running statistics within rtol "
                   "1e-3 / atol 1e-5; gradients " +
                   _dp_grad_bars(f"(b) {label}", one["grads"], r0["grads"],
                                 flips, 2e-4))
        want = _dp_want_counts(_cfg(B).model, impl)
        for r in (r0, r1):
            check(r["counts"] == want, f"dp (b) {label}: collectives "
                                       f"{r['counts']}, expected {want}")
            check(r["launches"] == DP_LAUNCHES[label],
                  f"dp (b) {label}: launches {r['launches']}")
        out[f"dp (b) {label} step, per rank"] = r0["launches"]
        print(f"dp (b) {label} step, B={B}, two ranks vs one process on "
              f"{card}: loss {r0['loss']:.6f} vs {one['loss']:.6f}; {got}; "
              f"gradients before Adam equal on both ranks; flipped decisions "
              f"{ {n: int(f.sum()) for n, f in flips.items()} }; parameters "
              f"bit-equal across the ranks after 3 steps; collectives a step "
              f"{r0['counts']}; launches a step {r0['launches']}",
              flush=True)

    # (c) NCCL at world size 1: its code path on the card.
    (r,) = spawn(_dp_nccl_rank, 1, "nccl", args=(dev.type, B),
                 timeout_s=300)
    want = _dp_want_counts(_cfg(B).model, "pair3")
    check(r["backend"] == "nccl" and r["dp"] == 1, f"dp (c): {r}")
    check(r["counts"] == want, f"dp (c): collectives {r['counts']}")
    check(r["launches"] == DP_LAUNCHES["pair3"], f"dp (c): {r['launches']}")
    check(math.isclose(r["loss"], losses["pair3"], rel_tol=2e-4),
          f"dp (c): loss {r['loss']} vs one process {losses['pair3']}")
    out["dp (c) nccl pair3 step"] = r["launches"]
    print(f"dp (c) pair3 step over NCCL at world size 1 on {card}: loss "
          f"{r['loss']:.6f} (one process {losses['pair3']:.6f}); collectives "
          f"{r['counts']}; launches {r['launches']}", flush=True)

    # (d) The shipped multichip config: its own width, B=512 with auto
    # (bf16 pair3) and B=128 with its own reference (cut, PERF.md).
    cfg_path = os.path.join(here, DP_CONFIG)
    for label, impl, Bg in DP_TIMED_CASES:
        ranks = spawn(_dp_time_rank, 2, "gloo",
                      args=(dev.type, cfg_path, impl, Bg, DP_WARM, DP_TIMED),
                      timeout_s=900)
        for k, rr in enumerate(ranks):
            check(all(math.isfinite(v) for v in rr["losses"]),
                  f"dp (d) {label} rank {k}: losses {rr['losses']}")
            check(rr["counts"] == _dp_want_counts(rr["model"], rr["impl"]),
                  f"dp (d) {label}: collectives {rr['counts']}")
        check(ranks[0]["losses"] == ranks[1]["losses"],
              f"dp (d) {label}: the ranks' losses differ")
        out[f"dp (d) multichip {label}, per rank"] = ranks[0]["launches"]
        _dp_kernels(dev, card, label, ranks[0])
        for k, rr in enumerate(ranks):
            ms, coll = sorted(rr["ms"]), rr["coll"].items()
            print(f"dp (d) {DP_CONFIG} sa_impl {label} -> {rr['impl']} "
                  f"{rr['dtype']}, B={Bg} ({Bg // 2} a rank), rank {k} of 2 "
                  f"time-sharing {card}: median {statistics.median(ms):.2f} "
                  f"ms/step (min {ms[0]:.2f}, max {ms[-1]:.2f}; {DP_TIMED} "
                  f"steps after {DP_WARM}); collectives a step on the "
                  f"host (synchronised, in {DP_TIMED} separate steps), kind: "
                  f"[ms, bytes, calls] "
                  f"{ {n: [round(v[0], 3), v[1], v[2]] for n, v in coll} }"
                  f"; peak {rr['peak']:.2f} GiB; collectives a step "
                  f"{rr['counts']}; "
                  f"launches a step {rr['launches']}; losses "
                  f"{rr['losses'][0]:.4f} .. {rr['losses'][-1]:.4f}",
                  flush=True)
    out.update(_dp_swav(dev, card, B))
    out.update(_dp_moco_slowfast(dev, card))
    # (h) and (i): one spawn of two ranks runs both (h)'s dp=1 x mp=2
    # mesh and (i)'s dp=2 mesh.
    t0 = time.perf_counter()
    ranks = spawn(_hi_rank, 2, "gloo", args=(dev.type, B), timeout_s=900)
    dt = time.perf_counter() - t0
    out.update(_dp_tensor_parallel(dev, card, [r["h"] for r in ranks], dt))
    out.update(_dp_covar_analytic(dev, card, [r["i"] for r in ranks], dt))
    return out


def _dp_swav(dev, card: str, B: int):
    """(f) The pair3 step with SwAV and CLD (f32): two gloo ranks against
    one process from the same weights, queue, points and permutation.
    Returns {path: launches}."""
    from facl_tpu_torch.parallel import spawn
    from facl_tpu_torch.train import Trainer
    t0 = time.perf_counter()
    ranks = spawn(_dp_swav_rank, 2, "gloo", args=(dev.type, B),
                  timeout_s=600)
    dt = time.perf_counter() - t0
    c = _dp_swav_cfg(B)
    pts, perm = _dp_points(B)
    sd = Trainer(c, 100, device="cpu").init_state(SEED).model.state_dict()
    one = _swav_step(dev, c, sd, filled_queue(c, SEED + 27), pts, perm, 10)
    _sync(dev, empty=True)
    r0, r1 = ranks
    check(r0["metrics"] == r1["metrics"], "dp (f): the ranks' losses differ")
    for k in ("loss", "loss_swav", "loss_cld"):
        check(math.isclose(r0["metrics"][k], one["metrics"][k],
                           rel_tol=2e-4), f"dp (f) {k}: {r0['metrics'][k]} "
              f"vs one process {one['metrics'][k]}")
    check(torch.equal(r0["queue"], r1["queue"]),
          "dp (f): the queue differs between the ranks")
    check(torch.allclose(r0["queue"], one["queue"], rtol=2e-4, atol=1e-5),
          "dp (f): the queue differs from one process's")
    for n, gr in r0["grads"].items():
        check(torch.equal(gr, r1["grads"][n]),
              f"dp (f): gradient {n} differs between the ranks")
    G = c.model.num_crops
    dk = _merge_decisions([r0["dec"], r1["dec"]], B, G)
    flips = {n: (one["dec"][n] != dk[n]).reshape(
        -1, one["dec"][n].shape[-1]) for n in one["dec"]}
    km = sum(int((a != b).sum()) for a, b in zip(one["labels"],
                                                 r0["labels"]))
    got = _swav_grad_bars("(f) pair3 SwAV+CLD", one["grads"], r0["grads"],
                          flips, km, 2e-4)
    want = _dp_want_counts(c.model, "pair3")
    want["gather_negatives"] += 2                  # code and x_nor
    for r in (r0, r1):
        check(r["counts"] == want, f"dp (f): collectives {r['counts']}, "
                                   f"expected {want}")
        check(r["launches"] == DP_LAUNCHES["pair3"],
              f"dp (f): launches {r['launches']}")
    print(f"dp (f) pair3 step with SwAV and CLD, B={B}, two gloo ranks vs "
          f"one process on {card} ({dt:.1f} s): loss "
          f"{r0['metrics']['loss']:.6f} vs {one['metrics']['loss']:.6f}, "
          f"swav {r0['metrics']['loss_swav']:.6f} vs "
          f"{one['metrics']['loss_swav']:.6f}, cld "
          f"{r0['metrics']['loss_cld']:.6f} vs "
          f"{one['metrics']['loss_cld']:.6f} (rtol 2e-4); queue bit-equal "
          f"across the ranks, within rtol 2e-4 / atol 1e-5 of one process's; "
          f"k-means "
          f"labels flipped {km} of {sum(a.numel() for a in one['labels'])}"
          f"; flipped decisions "
          f"{ {n: int(f.sum()) for n, f in flips.items()} }; gradients "
          f"before Adam {got}; collectives a step {r0['counts']}",
          flush=True)
    return {"dp (f) pair3 SwAV+CLD step, per rank": r0["launches"]}


def _dp_swav_cfg(B):
    return _swav_cfg(_cfg(B, "pair3"), use_swav=True, use_cld=True)


def _dp_swav_rank(devtype, B):
    """(f) on one rank: the pair3 SwAV+CLD step (f32, epoch 10, a full
    queue) on this rank's block: metrics, gradients before Adam, the new
    queue, decisions, k-means labels, collectives and launches."""
    from facl_tpu_torch.parallel import batch_slice, make_mesh, \
        rank_device, shard_train_state
    from facl_tpu_torch.train import Trainer
    mesh = make_mesh()
    dev = rank_device(devtype)
    pts, perm = _dp_points(B)
    c = _dp_swav_cfg(B)
    tr = Trainer(c, 100, device=dev, mesh=mesh)
    st = tr.init_state(SEED)
    st.swav_queue = filled_queue(c, SEED + 27).to(dev)
    st = shard_train_state(mesh, st)
    kernels = all_kernels()
    _dp_zero(kernels)
    dec, labels = {}, []
    with _decisions(st.model, "pair3", B // mesh.dp, dec), \
            kmeans_labels(labels):
        st, m = tr.step_fn(st, pts[:, batch_slice(mesh, B)].to(dev),
                           perm=perm, epoch=10)
    _sync(dev)
    return dict(metrics={n: float(v) for n, v in m.items()},
                counts=_dp_counts(), launches=_dp_launches(kernels),
                dec=_pack(dec), labels=labels,
                grads={n: p.grad.cpu() for n, p in
                       st.model.named_parameters() if p.grad is not None},
                queue=st.swav_queue.cpu())


#: (g): MoCo's global batch (32 a rank) and the slow/fast crop batch
#: (G x B videos, 40 clouds a rank: the decisions of both ranks cross the
#: process boundary).
DPG_MOCO_B, DPG_SF_B = 64, 8


def _dpg_inputs():
    """(g)'s MoCo views (2, B, N, 4) and slow/fast crop batch (G, B, N,
    4), randn from the seed."""
    g = torch.Generator().manual_seed(SEED + 51)
    return (torch.randn(2, DPG_MOCO_B, 512, 4, generator=g),
            torch.randn(SF_G, DPG_SF_B, 512, 4, generator=g))


def _dpg_rank(devtype):
    """(g) on one rank: the MoCo pair3 step at f32 and at bf16 on this
    rank's block of the views, and the slow/fast f32 step on its block of
    the crop batch (flattened as the pretrain CLI does), each from the
    seed's weights and queue: loss, gradients before Adam, decisions,
    queue and pointer, collectives and launches."""
    from facl_tpu_torch.parallel import batch_slice, make_mesh, \
        rank_device, shard_train_state
    from facl_tpu_torch.train import MoCoTrainer, SlowFastTrainer, \
        shard_moco_state
    mesh = make_mesh()
    dev = rank_device(devtype)
    views, crops = _dpg_inputs()
    kernels = all_kernels()
    out = {}
    for dtype in ("float32", "bfloat16"):
        tr = MoCoTrainer(_cfg(DPG_MOCO_B, "pair3", dtype=dtype), 100,
                         queue_len=MOCO_QUEUE, device=dev, mesh=mesh)
        st = shard_moco_state(mesh, tr.init_state(SEED, DPG_MOCO_B))
        _dp_zero(kernels)
        dec = {}
        with _decisions(st.model, "pair3", DPG_MOCO_B // mesh.dp, dec):
            st, m = tr.step_fn(st, views[:, batch_slice(mesh, DPG_MOCO_B)]
                               .to(dev))
        _sync(dev)
        out[f"moco {dtype}"] = dict(
            loss=float(m["loss"]), counts=_dp_counts(),
            launches=_dp_launches(kernels), dec=_pack(dec),
            grads={n: p.grad.cpu() for n, p in st.model.named_parameters()
                   if p.grad is not None},
            queue=st.moco.queue.cpu(), ptr=st.moco.queue_ptr)
        del tr, st
        _sync(dev, empty=True)
    tr = SlowFastTrainer(_sf_cfg(DPG_SF_B), 100, device=dev, mesh=mesh)
    st = shard_train_state(mesh, tr.init_state(SEED))
    local = crops[:, batch_slice(mesh, DPG_SF_B)]
    _dp_zero(kernels)
    dec = {}
    with _sf_decisions(st.model, dec):
        st, m = tr.step_fn(st, local.reshape(-1, *local.shape[2:]).to(dev))
    _sync(dev)
    out["slow_fast"] = dict(
        loss=float(m["loss"]), counts=_dp_counts(),
        launches=_dp_launches(kernels), dec=_pack(dec),
        grads={n: p.grad.cpu() for n, p in st.model.named_parameters()})
    return out


def _dp_moco_slowfast(dev, card: str):
    """(g) MoCo (pair3 f32 and bf16) and slow/fast (f32): two gloo ranks
    against one process from the same weights, queue and inputs. Returns
    {path: launches}."""
    from facl_tpu_torch.parallel import spawn
    t0 = time.perf_counter()
    ranks = spawn(_dpg_rank, 2, "gloo", args=(dev.type,), timeout_s=600)
    dt = time.perf_counter() - t0
    views, crops = _dpg_inputs()
    B = DPG_MOCO_B
    out = {}
    ones = {dtype: _moco_step(dev, _cfg(B, "pair3", dtype=dtype), views, B)
            for dtype in ("float32", "bfloat16")}
    halves = _moco_step(dev, _cfg(B, "pair3", dtype="bfloat16"), views, B,
                        halves=True)
    _sync(dev, empty=True)
    m_cfg = _cfg(B).model
    for dtype, label in (("float32", "pair3 f32"), ("bfloat16",
                                                    "pair3 bf16")):
        r0, r1 = (r[f"moco {dtype}"] for r in ranks)
        one = ones[dtype]
        check(r0["loss"] == r1["loss"], f"dp (g) moco {label}: the ranks' "
                                        f"losses {r0['loss']} {r1['loss']}")
        check(torch.equal(r0["queue"], r1["queue"]) and
              r0["ptr"] == r1["ptr"] == one["ptr"] == B,
              f"dp (g) moco {label}: queue or pointer differ between the "
              "ranks")
        for n, gr in r0["grads"].items():
            check(torch.equal(gr, r1["grads"][n]),
                  f"dp (g) moco {label}: gradient {n} differs between the "
                  "ranks")
        if dtype == "float32":
            check(math.isclose(r0["loss"], one["loss"], rel_tol=2e-4),
                  f"dp (g) moco {label}: loss {r0['loss']} vs one process "
                  f"{one['loss']}")
            check(torch.allclose(r0["queue"], one["queue"], rtol=5e-4,
                                 atol=5e-6),
                  f"dp (g) moco {label}: the queue differs from one "
                  "process's")
            dk = _merge_decisions([r0["dec"], r1["dec"]], B, 1)
            flips = {n: (one["dec"][n] != dk[n]).reshape(
                -1, one["dec"][n].shape[-1]) for n in one["dec"]}
            got = (f"loss within rtol 2e-4, queue within rtol 5e-4 / atol "
                   f"5e-6 of one process's; flipped decisions "
                   f"{ {n: int(f.sum()) for n, f in flips.items()} }; "
                   "gradients " + _dp_grad_bars(
                       f"(g) moco {label}", one["grads"], r0["grads"],
                       flips, 2e-4))
            want_l = PATHS["pair3"]
        else:
            # MoCo's loss sums exp(l_neg - l_pos) over logits of tens
            # (unnormalised embeddings, temperature 1), so its relative
            # rounding is the logits' absolute one, about 2^-8 of them at
            # bf16: phase 7 (b)'s rtol 2e-3 against one process would
            # hold the rounding of bf16 itself. The loss is held against
            # the f32 run (``_dp_vs_f32``) and at the f32 bar against one
            # process rounding as two ranks.
            rel = abs(r0["loss"] - one["loss"]) / abs(one["loss"])
            check(math.isclose(r0["loss"], halves["loss"], rel_tol=2e-4),
                  f"dp (g) moco {label}: loss {r0['loss']} vs one process "
                  f"as two halves {halves['loss']}")
            check(torch.allclose(r0["queue"], halves["queue"], rtol=5e-4,
                                 atol=5e-6),
                  f"dp (g) moco {label}: the queue differs from one process "
                  "as two halves")
            f32 = ones["float32"]
            top = max(float(t.abs().max()) for t in f32["grads"].values())
            live = [n for n, t in f32["grads"].items() if not
                    n.startswith(DP_ABSORBED) and
                    float(t.abs().max()) > 1e-6 * top]
            got = "; ".join([
                f"loss {rel:.3e} from one process's, within rtol 2e-4 of one "
                f"process as two halves "
                f"({abs(r0['loss'] - halves['loss']):.3e} apart); "
                "queue within rtol 5e-4 / atol 5e-6 of the halves' (from one "
                f"process's: {_rel_l2(r0['queue'], one['queue']):.3e} "
                "relative L2)"] + [
                _dp_vs_f32(f"(g) moco {label}", what, [r[k] for k in keys],
                           [o[k] for k in keys], [d[k] for k in keys])
                for what, keys, r, o, d in (
                    ("loss", ["loss"], *({"loss": torch.tensor(x["loss"])}
                                         for x in (f32, one, r0))),
                    ("gradients", live, f32["grads"], one["grads"],
                     r0["grads"]))])
            want_l = BF16_LAUNCHES["pair3 bf16"]
        want = _dp_want_counts(m_cfg, "pair3")
        want.update(global_moments=want["global_moments"] - 1,
                    gather_negatives=1, all_gather=1)
        want.pop("broadcast")
        for r in (r0, r1):
            check(r["counts"] == want, f"dp (g) moco {label}: collectives "
                                       f"{r['counts']}, expected {want}")
            check(r["launches"] == want_l,
                  f"dp (g) moco {label}: launches {r['launches']}")
        out[f"dp (g) moco {label} step, per rank"] = r0["launches"]
        print(f"dp (g) moco {label} step, B={B} ({B // 2} a rank), two gloo "
              f"ranks vs one process on {card}: loss {r0['loss']:.6f} vs "
              f"{one['loss']:.6f}; {got}; queue and pointer ({r0['ptr']}) "
              f"and gradients bit-equal across the ranks; collectives a step "
              f"{r0['counts']}; launches a step {r0['launches']}",
              flush=True)
    del ones, halves

    # Slow/fast: one process on the ranks' rows in rank order (a
    # permutation of the crop-major order; the loss does not change), so
    # the decisions line up row for row.
    cfg = _sf_cfg(DPG_SF_B)
    h = DPG_SF_B // 2
    order = torch.cat([crops[:, :h].reshape(-1, 512, 4),
                       crops[:, h:].reshape(-1, 512, 4)])
    one = _sf_step(dev, cfg, order)
    _sync(dev, empty=True)
    r0, r1 = (r["slow_fast"] for r in ranks)
    check(r0["loss"] == r1["loss"], "dp (g) slow_fast: the ranks' losses "
                                    "differ")
    check(math.isclose(r0["loss"], one["loss"], rel_tol=2e-4),
          f"dp (g) slow_fast: loss {r0['loss']} vs one process "
          f"{one['loss']}")
    for n, gr in r0["grads"].items():
        check(torch.equal(gr, r1["grads"][n]),
              f"dp (g) slow_fast: gradient {n} differs between the ranks")
    d0, d1 = _unpack(r0["dec"]), _unpack(r1["dec"])
    flips = _flips(one["dec"], {n: torch.cat([d0[n], d1[n]]) for n in d0})
    got = _sf_grad_bars("dp (g) slow_fast", cfg.model, one["grads"],
                        r0["grads"], flips)
    want = {"global_moments": 28, "gather_negatives": 2, "psum_grads": 1}
    for r in (r0, r1):
        check(r["counts"] == want, f"dp (g) slow_fast: collectives "
                                   f"{r['counts']}, expected {want}")
        check(r["launches"] == {"select_gather": 2},
              f"dp (g) slow_fast: launches {r['launches']}")
    out["dp (g) slow_fast step, per rank"] = r0["launches"]
    print(f"dp (g) slow_fast f32 step, {SF_G} x {DPG_SF_B} clouds "
          f"({SF_G * h} a rank), two gloo ranks vs one process on {card} "
          f"({dt:.1f} s for the ranks): loss {r0['loss']:.6f} vs "
          f"{one['loss']:.6f} (rtol 2e-4); flipped decisions {flips}; "
          f"gradients before Adam {got}, bit-equal across the ranks; "
          f"collectives a step {r0['counts']}; launches a step "
          f"{r0['launches']}", flush=True)
    return out


# -- phase 7 (h): tensor parallelism; (i): covar and analytic under dp ---

#: (h): ms/step over TP_TIMED steps after TP_WARM, a rank.
TP_WARM, TP_TIMED = 2, 5
#: (i): the cases (impl, dtype); ms/step over DPI_TIMED after DPI_WARM.
DPI_CASES = (("covar", "float32"), ("covar", "bfloat16"),
             ("analytic", "float32"), ("analytic", "bfloat16"))
DPI_WARM, DPI_TIMED = 1, 3


def _tp_splits(model_cfg):
    """Split Dense calls of one forward at mp > 1 (the mp rule: 512 output
    columns or more): stage-2's layers, the head's two layers twice (the
    crops, then the videos), the prototype mapping."""
    from facl_tpu_torch.parallel.mesh import MP_MIN_COLUMNS
    wide = sum(w >= MP_MIN_COLUMNS for w in model_cfg.stage2_widths)
    wide += 2 * sum(w >= MP_MIN_COLUMNS for w in (model_cfg.fc_hidden,
                                                   model_cfg.embed_dim))
    return wide + (model_cfg.num_prototypes >= MP_MIN_COLUMNS)


def _tp_timed(tr, st, local, perm, dev):
    """TP_WARM steps, then TP_TIMED timed by CUDA events between steps, then
    TP_TIMED more with each collective timed on the host
    (``_timed_collectives``). Returns ms per step, collectives' [host ms,
    bytes, calls] a step by kind and the peak allocation (GiB)."""
    for _ in range(TP_WARM):
        st, _ = tr.step_fn(st, local, perm=perm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(TP_TIMED + 1)]
    ev[0].record()
    for i in range(TP_TIMED):
        st, _ = tr.step_fn(st, local, perm=perm)
        ev[i + 1].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    acc = {}
    with _timed_collectives(acc, dev):
        for _ in range(TP_TIMED):
            st, _ = tr.step_fn(st, local, perm=perm)
    torch.cuda.synchronize()
    return dict(ms=[ev[i].elapsed_time(ev[i + 1]) for i in range(TP_TIMED)],
                coll={k: [v[0] / TP_TIMED, v[1] // TP_TIMED,
                          v[2] // TP_TIMED] for k, v in acc.items()},
                peak=peak)


def _tp_rank(devtype, B, shape, dtypes, timed):
    """(h) on one rank of the dp x mp mesh ``shape``: for each of
    ``dtypes`` the pair3 Trainer at bench.py's workload from the seed's
    weights (global rank 0's, placed by shard_train_state) on this rank's
    dp block: the first step's loss, gradients before Adam (a split
    weight's blocks gathered whole), BatchNorm buffers, decisions,
    launches, collectives and the bytes of parameters plus Adam state; the
    whole state (parameters and buffers) after a second step; with
    ``timed``, ``_tp_timed``."""
    from facl_tpu_torch.config import MeshConfig
    from facl_tpu_torch.models.layers import column_blocks, full_state_dict
    from facl_tpu_torch.parallel import batch_slice, make_mesh, mp_full, \
        rank_device, shard_train_state
    from facl_tpu_torch.train import Trainer
    mesh = make_mesh(MeshConfig(*shape))
    dev = rank_device(devtype)
    pts, perm = _dp_points(B)
    local = pts[:, batch_slice(mesh, B)].to(dev)
    kernels = all_kernels()
    out = {"at": (mesh.rank, mesh.mp_rank)}
    for dtype in dtypes:
        tr = Trainer(_cfg(B, "pair3", dtype=dtype), 100, device=dev,
                     mesh=mesh)
        st = shard_train_state(mesh, tr.init_state(SEED))
        _dp_zero(kernels)
        dec = {}
        with _decisions(st.model, "pair3", B // mesh.dp, dec):
            st, m = tr.step_fn(st, local, perm=perm)
        _sync(dev)
        res = dict(loss=float(m["loss"]), counts=_dp_counts(),
                   launches=_dp_launches(kernels), dec=_pack(dec),
                   bytes=_state_bytes(st),
                   buffers={n: b.cpu().clone() for n, b in
                            st.model.named_buffers()})
        blocks = column_blocks(st.model)
        res["grads"] = {n: (mp_full(p.grad, mesh) if id(p) in blocks
                            else p.grad).cpu()
                        for n, p in st.model.named_parameters()
                        if p.grad is not None}
        st, _ = tr.step_fn(st, local, perm=perm)
        res["state_end"] = {n: t.cpu() for n, t in
                            full_state_dict(st.model).items()}
        if timed:
            res.update(_tp_timed(tr, st, local, perm, dev))
        out[dtype] = res
        del tr, st
        _sync(dev, empty=True)
    return out


def _tp_checks(label, ranks, dtype, want_counts, want_launches):
    """The ranks of (h) agree: loss, whole gradients and the whole state
    after two steps bit-equal; collectives and launches as counted."""
    r0 = ranks[0][dtype]
    for k, rk in enumerate(ranks):
        r = rk[dtype]
        check(r["loss"] == r0["loss"], f"dp (h) {label}: rank {k}'s loss "
                                       f"{r['loss']} vs {r0['loss']}")
        for n, g in r0["grads"].items():
            check(torch.equal(g, r["grads"][n]),
                  f"dp (h) {label}: gradient {n} differs on rank {k}")
        for n, t in r0["state_end"].items():
            check(torch.equal(t, r["state_end"][n]),
                  f"dp (h) {label}: {n} differs on rank {k} after 2 steps")
        check(r["counts"] == want_counts, f"dp (h) {label}: rank {k}'s "
              f"collectives {r['counts']}, expected {want_counts}")
        check(r["launches"] == want_launches, f"dp (h) {label}: rank {k}'s "
              f"launches {r['launches']}")


def _hi_rank(devtype, B):
    """(h)'s two ranks at dp = 1 x mp = 2 (``_tp_rank``), then (i) on the
    same two ranks at dp = 2 (``_dpi_rank``)."""
    return {"h": _tp_rank(devtype, B, (1, 2), ("float32", "bfloat16"),
                          True),
            "i": _dpi_rank(devtype, B)}


def _dp_tensor_parallel(dev, card: str, ranks, dt):
    """(h) Tensor parallelism (mesh.mp > 1) at bench.py's workload: two
    gloo ranks at dp = 1 x mp = 2 time-sharing the card (``ranks``, their
    ``_tp_rank`` results; ``dt`` s for the spawn), pair3 f32 and bf16,
    against one process from the same weights, points and permutation;
    then one f32 step on four ranks (dp = 2 x mp = 2). Returns {path:
    launches}."""
    from facl_tpu_torch.parallel import spawn
    B = DP_B
    model_cfg = _cfg(B).model
    splits = {"mp_enter": _tp_splits(model_cfg),
              "mp_gather_cols": _tp_splits(model_cfg)}
    ones = {dtype: _dp_one_step(dev, B, "pair3", dtype)
            for dtype in ("float32", "bfloat16")}
    cols = _dp_one_step(dev, B, "pair3", "bfloat16", "columns")
    _sync(dev, empty=True)
    out = {}
    for dtype, label in (("float32", "pair3"), ("bfloat16", "pair3 bf16")):
        want_l = DP_LAUNCHES[label]
        _tp_checks(label, ranks, dtype, dict(splits, broadcast=1), want_l)
        r0, one = ranks[0][dtype], ones[dtype]
        if dtype == "float32":
            check(math.isclose(r0["loss"], one["loss"], rel_tol=2e-4),
                  f"dp (h) {label}: loss {r0['loss']} vs one process "
                  f"{one['loss']}")
            for n, w in one["buffers"].items():
                check(torch.allclose(r0["buffers"][n], w, rtol=1e-3,
                                     atol=1e-5),
                      f"dp (h) {label}: running statistic {n}")
            dk = _unpack(r0["dec"])
            flips = {n: (one["dec"][n] != dk[n]).reshape(
                -1, one["dec"][n].shape[-1]) for n in one["dec"]}
            got = ("loss within rtol 2e-4, running statistics within rtol "
                   f"1e-3 / atol 1e-5; flipped decisions "
                   f"{ {n: int(f.sum()) for n, f in flips.items()} }; "
                   "gradients " + _dp_grad_bars(
                       f"(h) {label}", one["grads"], r0["grads"], flips,
                       2e-4))
        else:
            got = _dp_bf16_step(label, ones["float32"], one, r0,
                                {"columns": cols}, "columns", "(h)")
            same = [n for n, g in cols["grads"].items()
                    if torch.equal(g, r0["grads"][n])]
            got += (f"; gradients bit-equal to one process as two column "
                    f"blocks: {len(same)} of {len(cols['grads'])} tensors")
        saved = one["bytes"] - r0["bytes"]
        out[f"dp (h) mp2 {label} step, per rank"] = r0["launches"]
        ms = sorted(r0["ms"])
        coll = {n: [round(v[0], 3), v[1], v[2]]
                for n, v in r0["coll"].items()}
        print(f"dp (h) tensor parallel {label} step, B={B}, dp=1 x mp=2 "
              f"(two gloo ranks time-sharing {card}, {dt:.1f} s for the "
              f"ranks, (i) included) vs one process: loss {r0['loss']:.6f} vs "
              f"{one['loss']:.6f}; {got}; loss, whole gradients, parameters "
              f"and BatchNorm buffers bit-equal across the ranks after 2 "
              f"steps; parameters + Adam state a rank {r0['bytes']} bytes, "
              f"one process {one['bytes']} ({saved} saved); rank 0 median "
              f"{statistics.median(ms):.2f} ms/step (min {ms[0]:.2f}, max "
              f"{ms[-1]:.2f}; {TP_TIMED} steps after {TP_WARM}; rank 1 "
              f"median {statistics.median(ranks[1][dtype]['ms']):.2f}); "
              f"peak {r0['peak']:.2f} GiB a rank; collectives a step on the "
              f"host (synchronised, in {TP_TIMED} separate steps), kind: "
              f"[ms, bytes, calls] {coll}; collectives a step "
              f"{r0['counts']}; launches a step "
              f"{r0['launches']}", flush=True)
        check(saved == 3 * 4 * _tp_split_numel(model_cfg) // 2,
              f"dp (h) {label}: a rank saves {saved} bytes, expected half "
              "of the split kernels and their two Adam moments")

    # One f32 step on four ranks: dp = 2 x mp = 2.
    t0 = time.perf_counter()
    ranks = spawn(_tp_rank, 4, "gloo", args=(dev.type, B, (2, 2),
                                             ("float32",), False),
                  timeout_s=600)
    dt = time.perf_counter() - t0
    one = ones["float32"]
    want = dict(_dp_want_counts(model_cfg, "pair3"), **splits)
    _tp_checks("dp2 x mp2 pair3", ranks, "float32", want,
               DP_LAUNCHES["pair3"])
    r0 = ranks[0]["float32"]
    check(math.isclose(r0["loss"], one["loss"], rel_tol=2e-4),
          f"dp (h) dp2 x mp2: loss {r0['loss']} vs one process "
          f"{one['loss']}")
    for n, w in one["buffers"].items():
        check(torch.allclose(r0["buffers"][n], w, rtol=1e-3, atol=1e-5),
              f"dp (h) dp2 x mp2: running statistic {n}")
    blocks = [rk["float32"] for rk in ranks if rk["at"][1] == 0]
    dk = _merge_decisions([b["dec"] for b in blocks], B,
                          model_cfg.num_crops)
    flips = {n: (one["dec"][n] != dk[n]).reshape(
        -1, one["dec"][n].shape[-1]) for n in one["dec"]}
    got = _dp_grad_bars("(h) dp2 x mp2 pair3", one["grads"], r0["grads"],
                        flips, 2e-4)
    out["dp (h) dp2 x mp2 pair3 step, per rank"] = r0["launches"]
    print(f"dp (h) tensor parallel pair3 f32 step, B={B}, dp=2 x mp=2 (four "
          f"gloo ranks time-sharing {card}, {dt:.1f} s) vs one process: loss "
          f"{r0['loss']:.6f} vs {one['loss']:.6f} (rtol 2e-4); running "
          f"statistics within rtol 1e-3 / atol 1e-5; flipped decisions "
          f"{ {n: int(f.sum()) for n, f in flips.items()} }; gradients "
          f"before Adam {got}; bit-equal across the four ranks after 2 "
          f"steps; collectives a step {r0['counts']}", flush=True)
    return out


def _tp_split_numel(model_cfg):
    """Entries of the kernels the mp rule splits at ``model_cfg``'s
    widths."""
    from facl_tpu_torch.parallel.mesh import MP_MIN_COLUMNS
    dims = [3 + model_cfg.sa_widths[-1], *model_cfg.stage2_widths,
            model_cfg.fc_hidden, model_cfg.embed_dim,
            model_cfg.num_prototypes]
    return sum(a * b for a, b in zip(dims, dims[1:]) if b >= MP_MIN_COLUMNS)


def _dpi_rank(devtype, B):
    """(i) on one rank: for each of DPI_CASES the Trainer from the seed's
    weights (rank 0's) on this rank's block of (b)'s points: the first
    step's loss, gradients before Adam, BatchNorm buffers, decisions,
    launches and collectives; then DPI_WARM steps and DPI_TIMED timed by
    CUDA events between steps."""
    from facl_tpu_torch.parallel import batch_slice, make_mesh, \
        rank_device, shard_train_state
    from facl_tpu_torch.train import Trainer
    mesh = make_mesh()
    dev = rank_device(devtype)
    pts, perm = _dp_points(B)
    local = pts[:, batch_slice(mesh, B)].to(dev)
    kernels = all_kernels()
    out = {}
    for impl, dtype in DPI_CASES:
        tr = Trainer(_cfg(B, impl, dtype=dtype), 100, device=dev, mesh=mesh)
        st = shard_train_state(mesh, tr.init_state(SEED))
        _dp_zero(kernels)
        dec = {}
        with _decisions(st.model, impl, B // mesh.dp, dec):
            st, m = tr.step_fn(st, local, perm=perm)
        _sync(dev)
        res = dict(loss=float(m["loss"]), counts=_dp_counts(),
                   launches=_dp_launches(kernels), dec=_pack(dec),
                   grads={n: p.grad.cpu() for n, p in
                          st.model.named_parameters() if p.grad is not None},
                   buffers={n: b.cpu().clone() for n, b in
                            st.model.named_buffers()})
        for _ in range(DPI_WARM):
            st, _ = tr.step_fn(st, local, perm=perm)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(DPI_TIMED + 1)]
        ev[0].record()
        for i in range(DPI_TIMED):
            st, _ = tr.step_fn(st, local, perm=perm)
            ev[i + 1].record()
        torch.cuda.synchronize()
        res["ms"] = [ev[i].elapsed_time(ev[i + 1]) for i in range(DPI_TIMED)]
        out[impl, dtype] = res
        del tr, st
        _sync(dev, empty=True)
    return out


def _dp_covar_analytic(dev, card: str, ranks, dt):
    """(i) covar and analytic under data parallelism at bench.py's
    workload (B=64, 32 a rank): two gloo ranks (``ranks``, their
    ``_dpi_rank`` results; ``dt`` s for the spawn, (h) included) against
    one process from the same weights, points and permutation; f32 at
    (b)'s f32 bars with flips counted, bf16 at (b)'s bf16 bars against
    one process as two halves (covar's Gram and column sums, analytic's
    backward sums split as the ranks split them). Returns {path:
    launches}."""
    B = DP_B
    out, f32 = {}, {}
    model_cfg = _cfg(B).model
    for impl, dtype in DPI_CASES:
        label = impl if dtype == "float32" else f"{impl} bf16"
        r0, r1 = ranks[0][impl, dtype], ranks[1][impl, dtype]
        one = _dp_one_step(dev, B, impl, dtype)
        check(r0["loss"] == r1["loss"], f"dp (i) {label}: the ranks' losses "
                                        f"{r0['loss']} {r1['loss']}")
        for n, g in r0["grads"].items():
            check(torch.equal(g, r1["grads"][n]),
                  f"dp (i) {label}: gradient {n} differs between the ranks")
        want = _dp_want_counts(model_cfg, impl)
        for r in (r0, r1):
            check(r["counts"] == want, f"dp (i) {label}: collectives "
                                       f"{r['counts']}, expected {want}")
            check(r["launches"] == {"select_gather": 1},
                  f"dp (i) {label}: launches {r['launches']}")
        if dtype == "float32":
            f32[impl] = one
            check(math.isclose(r0["loss"], one["loss"], rel_tol=2e-4),
                  f"dp (i) {label}: loss {r0['loss']} vs one process "
                  f"{one['loss']}")
            for n, w in one["buffers"].items():
                check(torch.allclose(r0["buffers"][n], w, rtol=1e-3,
                                     atol=1e-5),
                      f"dp (i) {label}: running statistic {n}")
            dk = _merge_decisions([r0["dec"], r1["dec"]], B,
                                  model_cfg.num_crops)
            flips = {n: (one["dec"][n] != dk[n]).reshape(
                -1, one["dec"][n].shape[-1]) for n in one["dec"]}
            got = ("loss within rtol 2e-4, running statistics within rtol "
                   f"1e-3 / atol 1e-5; flipped decisions "
                   f"{ {n: int(f.sum()) for n, f in flips.items()} }; "
                   "gradients " + _dp_grad_bars(
                       f"(i) {label}", one["grads"], r0["grads"], flips,
                       2e-4))
        else:
            halves = _dp_one_step(dev, B, impl, dtype, "halves")
            got = _dp_bf16_step(label, f32[impl], one, r0,
                                {"halves": halves}, "halves", "(i)")
        _sync(dev, empty=True)
        out[f"dp (i) {label} step, per rank"] = r0["launches"]
        ms = sorted(r0["ms"])
        print(f"dp (i) {label} step, B={B} ({B // 2} a rank), two gloo ranks "
              f"vs one process on {card} ({dt:.1f} s for the ranks, with "
              f"(h)): loss {r0['loss']:.6f} vs {one['loss']:.6f}; {got}; "
              f"gradients before Adam equal on both ranks; rank 0 median "
              f"{statistics.median(ms):.2f} ms/step (min {ms[0]:.2f}, max "
              f"{ms[-1]:.2f}; {DPI_TIMED} steps after {DPI_WARM}; rank 1 "
              f"median {statistics.median(r1['ms']):.2f}); collectives a "
              f"step {r0['counts']}; launches a step {r0['launches']}",
              flush=True)
    return out


def _dp_clis(dev, card, root, common, ck, tmp):
    """Phase 7 (e): pretrain --mesh (one epoch from the shipped motion
    config) and extract --mesh under torchrun, two gloo ranks on this
    card; each video's features against the one-process extract (in this
    process) from the same checkpoint, at 1e-5 of their scale. Both
    extractions run in f32 (``--dtype float32``): at bf16 the two batch
    compositions round products differently (the GEMMs' row counts
    differ), which the 1e-5 bar would not hold."""
    import numpy as np
    from facl_tpu_torch.cli import extract
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m"]
    mesh = ["--mesh", "--dist-backend", "gloo"]
    feat_dp, feat_one = (os.path.join(tmp, f) for f in ("feat_dp", "feat_1"))
    calls = (("pretrain", ["facl_tpu_torch.cli.pretrain"] + common + mesh +
              ["--epochs", "1", "--out", ck]),
             ("extract", ["facl_tpu_torch.cli.extract"] + common + mesh +
              ["--dtype", "float32", "--checkpoint", ck, "--out", feat_dp]))
    for name, argv in calls:
        t0 = time.perf_counter()
        proc = subprocess.run(run + argv, cwd=here, env=env,
                              capture_output=True, text=True, timeout=600)
        check(proc.returncode == 0, f"dp (e) torchrun {name}: exit "
                                    f"{proc.returncode}\n{proc.stdout[-3000:]}"
                                    f"\n{proc.stderr[-3000:]}")
        lines = [ln for ln in proc.stdout.splitlines()
                 if "epoch 0 done" in ln or "mesh:" in ln]
        print(f"dp (e) torchrun --nproc_per_node 2 {name} --mesh "
              f"--dist-backend gloo on {card}: {time.perf_counter() - t0:.1f}"
              f" s; {' | '.join(lines)}", flush=True)
    extract.main(common + ["--dtype", "float32", "--checkpoint", ck, "--out",
                           feat_one])
    names = sorted(f for f in os.listdir(feat_one) if f.endswith(".npy"))
    check(sorted(os.listdir(feat_dp)) == names,
          "dp (e): the mesh extract wrote other files")
    worst = 0.0
    for f in names:
        a, b = np.load(os.path.join(feat_dp, f)), np.load(
            os.path.join(feat_one, f))
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    check(worst <= 1e-5, f"dp (e): features differ by {worst:.3e} of scale")
    print(f"dp (e) extract --mesh vs one process on {card}: {len(names)} "
          f"videos, worst max-abs/scale {worst:.3e} (bar 1e-5)", flush=True)


def _data_cfg(here: str, stream: str):
    """The DataConfig the CLIs build for ``stream`` from its shipped
    config and protocol (cli/pretrain.py build_config)."""
    import dataclasses
    from facl_tpu_torch.config import Config
    cfg_path, protocol = CONFIGS[stream]
    with open(os.path.join(here, cfg_path)) as f:
        data = Config.from_json(f.read()).data
    return dataclasses.replace(data, stream=stream, protocol=protocol)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of the parent commit: its select.cu, "
                         "sa_pair.cu, sa_2sweep.cu and sa_fused.cu are "
                         "built and its B1, B2a-B3c (f32 and bf16), the f32 "
                         "B6, B7, B8 and B9 timed against this tree's in "
                         "turns, their outputs bit-equal (the bf16 ones "
                         "within phase 2's bf16 bars); and "
                         "the pair3 bf16 step with the parent's bf16 B2b "
                         "and B3b")
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
            if "registers" in line or "spill" in line or \
                    "Compiling entry" in line:
                print(f"ptxas {src}: {line.strip()}", flush=True)
    if parent:
        load_parent(parent)

    from facl_tpu_torch.train import Trainer
    clock = [time.perf_counter()]

    def lap(name):
        """The seconds since the last lap (each phase's wall time)."""
        torch.cuda.empty_cache()
        clock.append(time.perf_counter())
        print(f"phase {name}: {clock[-1] - clock[-2]:.1f} s", flush=True)
    model = Trainer(_cfg(64), 100, device=dev).init_state(SEED).model
    g = torch.Generator().manual_seed(SEED)
    points = torch.randn(10, 64, 512, 4, generator=g).to(dev)
    rows = phase_kernels(dev, model, points)
    del model, points
    lap("2 kernels")
    phase_cpu_vs_card(dev)
    lap("3 cpu-vs-card")
    paths, medians = phase_main(dev, args.profile, name_power)
    lap("4 main")
    paths.update(phase_input_grad(dev))
    lap("5 input")
    paths.update(phase_pipeline(dev, name_power, medians))
    lap("6 pipeline")
    paths.update(phase_swav(dev, name_power, medians, args.profile))
    lap("6b swav")
    paths.update(phase_datagen(
        dev, name_power, args.profile, then=lambda tree, tmp:
        moco_slowfast_clis(dev, name_power, tree, tmp)))
    lap("6c datagen")
    paths.update(phase_moco_slowfast(dev, name_power, args.profile))
    lap("6d moco/slow_fast")
    paths.update(phase_dp(dev, name_power))
    lap("7 dp")

    # Each kernel's launches: from the first path (in the order run) that
    # runs it — B1-B3 on pair3, B6 on pair, B7 and B8 on hybrid2 (their
    # bf16 forms on the bf16 paths), B9 on
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
