"""The order of sums of the bf16 forms of B2a (sa_fwd_layer12_bf16), B2b
(sa_fwd_gram_pool_bf16), B3a (sa_bwd_sweep1_bf16), B3b
(sa_bwd_sweep2_bf16), B3c (sa_bwd_sweep3_bf16) and B8a
(sa_bwd2_sweep1_bf16, ``b8a_model`` below), modelled in torch on the
CPU, held against their bf16 twins and against the JAX kernels they
port; chip_smoke.py's comparison of a bf16 sweep's outputs with another
tree's (``--parent``); and its profiled kernel time (``kernel_ms``).

On the card the kernels take bf16 operands, run every product as
mma.sync m16n8k16 (exact bf16 products summed into f32 accumulators one
k16 step at a time), sum each 64-row tile's contraction over rows (Gram,
A2, G1) in f32 and carry the tiles in float64, and sum the column sums
(colsum(h2), u2, ch1) in f32 over 16 rows before carrying them in
float64. B3a takes q3 as the TPU kernel's dense product D bf16(W3)^T
(D = bf16(dy3 bf16(gi3)), one value per (group, channel) at its argmax
row) in k16 steps into f32, and carries A3 in f32 entry by entry; B3c
sums [A1 | u1] = dy1^T [x | 1] one 16-row k16 step at a time into f32.
B2a makes h1 by its CUDA-core chain (x W1 channel by channel in f32),
takes h1 bf16(W2) in k16 steps into f32 and sums p2 and p2^2 in f32 over
each warp's 32-row step, carried in float64. ``layer12_model``,
``gram_pool_model``, ``sweep1_model``, ``sweep2_model`` and
``sweep3_model`` below compute the same functions in those orders (a k16
step summed in float64 and rounded to f32, then added to the f32
accumulator; the rest as the twins cast it), so the bars the card is
held to can be checked against that order here:

  * at bench.py's magnitudes (the model's SA weights at full width,
    randn clouds grouped at S = K = 64 and at the fine variant's S = 32,
    K = 128), on rows with bf16 near-ties (padded rows repeated and
    nudged by one bf16 ulp: of p2 for B2b and B3b, of x for B2a) and,
    for B3a, on an argmax layout skewed as
    the main path's (most of a group's channels on its first row, a
    third dead), the model sits within chip_smoke.py phase 2's
    bf16 bars of the bf16 twins: bf16 rows within one bf16 ulp but at most
    1e-3 of the entries, pool indices equal but at bf16 near-ties, f32
    accumulators within 1e-3 of their max-abs (chip_smoke's own helpers);
  * on tests/test_torch_bf16_sa.py's tiny shapes it sits within that
    file's tolerances of the JAX kernels run in interpret mode.
"""
import contextlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facl_tpu.ops.pallas.sa_kernel as jsk
import facl_tpu.ops.pallas.sa_pair as jsp
from facl_tpu.ops.pallas.sa_bwd import _fold_affine as jax_fold_affine
from facl_tpu.ops.pallas.sa_bwd import _layer_terms as jax_layer_terms
from facl_tpu_torch.ops import sa_kernel as SK
from facl_tpu_torch.ops import sa_pair as SP
from facl_tpu_torch.ops.sa_bwd import _fold_affine, _layer_terms
from facl_tpu_torch.ops.sa_fwd import _finalize
from tests.test_torch_bf16_sa import BF, C0, EPS, K as K_TINY, S as S_TINY, \
    WIDTHS, _acc, _bf16_rows, _fold2, _lanes, _Recorder, _setup, _t, \
    _unpair
from tests.test_torch_cuda import padded_groups

BF16 = torch.bfloat16
ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


# -- the model ------------------------------------------------------------

def _h1_chain(x3, w1, b1, mul1, shift1):
    """h1 as B2a-bf16 makes it: x bf16(W1) summed channel by channel in f32
    from the first product (each product and sum rounded), p1 = bf16(that)
    + bf16(b1) in f32, h1 = relu(bf16(p1 mul1 + shift1))."""
    xr, w = SP._rows(x3).float(), SP._rb(w1)
    a = xr[:, :1] * w[0]
    for k in range(1, xr.shape[1]):
        a = a + xr[:, k:k + 1] * w[k]
    return SP._h_bf16(SP._rb(a) + SP._rb(b1), mul1, shift1)


def layer12_model(x3, w1, b1, mul1, shift1, w2, b2, step=32):
    """B2a-bf16 in the kernel's order of sums (its twin's outputs): h1 by
    its chain; h1 bf16(W2) in k16 steps into f32; p2 = bf16(acc) +
    bf16(b2) in f32, stored rounded; the sums of p2 and p2^2 in f32 over
    each 32-row step, the steps carried in float64."""
    h1 = _h1_chain(x3, w1, b1, mul1, shift1)
    p2 = SP._rb(_k16(h1, SP._rb(w2))) + SP._rb(b2)

    def sums(v):
        return v.reshape(-1, step, v.shape[1]).sum(1).double().sum(0).float()
    return p2.to(BF16), sums(p2), sums(p2 * p2)


def _k16(a, b):
    """a (m, k) @ b (k, n) of bf16 values: each k16 step's products summed
    (float64, rounded to f32), the steps added to an f32 accumulator in k
    order."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], 16):
        acc = acc + (a[:, k0:k0 + 16].double()
                     @ b[k0:k0 + 16].double()).float()
    return acc


def _acc_rows(a, b, tile=64):
    """a^T b over rows: each 64-row tile by _k16 (f32), the tiles summed in
    float64."""
    out = torch.zeros(a.shape[1], b.shape[1], dtype=torch.float64)
    for r0 in range(0, a.shape[0], tile):
        out += _k16(a[r0:r0 + tile].T, b[r0:r0 + tile]).double()
    return out.float()


def _colsum16(v):
    """Column sums: f32 over each 16 rows, carried in float64."""
    return v.reshape(-1, 16, v.shape[1]).sum(1).double().sum(0).float()


def gram_pool_model(p2, mul2, shift2, w3, b3, pool: int):
    """B2b-bf16 in the kernel's order of sums (its twin's outputs)."""
    h2 = SP._h2_bf16(p2, mul2, shift2)
    p3 = (SP._rb(_k16(h2, SP._rb(w3))) + SP._rb(b3)).reshape(
        -1, pool, w3.shape[1])
    mx, mn = p3.amax(1), p3.amin(1)
    return (_acc_rows(h2, h2), _colsum16(h2), mx.to(BF16), mn.to(BF16),
            SP._first_index(p3, mx, pool), SP._first_index(p3, mn, pool))


def sweep2_model(x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3, M3, rc3,
                 gi2, w2):
    """B3b-bf16 in the kernel's order of sums (its twin's outputs)."""
    h1 = SP._h1_bf16(x3, w1, b1, mul1, shift1)
    h2 = SP._h2_bf16(p2, mul2, shift2)
    dy2 = torch.where(h2 > 0, q3.float() - SP._rb(_k16(h2, SP._rb(M3)))
                      - rc3, 0.0)
    dy2d = SP._rb(dy2)
    q2 = SP._rb(_k16(SP._rb(dy2d * SP._rb(gi2)), SP._rb(w2).T))
    mq = torch.where(h1 > 0, q2, 0.0)
    return (_acc_rows(dy2d, h1), _acc_rows(h1, h1), _colsum16(dy2),
            _colsum16(h1), mq.to(BF16))


def sweep1_model(p2, mul2, shift2, dpooled, idx, gi3, w3, pool: int):
    """B3a-bf16 in the kernel's order of sums (its twin's outputs): q3 the
    dense product in k16 steps; A3 carried in f32, one (exact) product of
    each live entry added group by group in row order (one block walking
    every tile: the longest f32 chain the kernel can carry); u3 summed in
    f32 per 64-row tile (8 pool rows for pool < 8), carried in float64."""
    h2 = SP._h2_bf16(p2, mul2, shift2)
    dy3 = SP._dy3(dpooled.float(), idx, pool)
    q3 = SP._rb(_k16(SP._rb(dy3 * SP._rb(gi3)), SP._rb(w3).T))
    A3 = torch.zeros(dy3.shape[1], h2.shape[1])
    for r0 in range(0, h2.shape[0], pool):
        A3 = A3 + dy3[r0:r0 + pool].T @ h2[r0:r0 + pool]
    tile = 64 if pool >= 8 else 8 * pool
    u3 = dy3.reshape(-1, tile, dy3.shape[1]).sum(1).double().sum(0)
    return A3, u3.float(), q3.to(BF16)


def sweep3_model(x3, w1, b1, mul1, shift1, mq, M2, rc2):
    """B3c-bf16 in the kernel's order of sums (its twin's outputs): h1
    bf16(M2) in k16 steps; [A1 | u1] one 16-row k16 step at a time into
    f32 (one warp walking every row: the longest f32 chain), then
    float64."""
    h1 = SP._h1_bf16(x3, w1, b1, mul1, shift1)
    dy1 = SP._rb(torch.where(h1 > 0, mq.float() - (SP._rb(_k16(
        h1, SP._rb(M2))) + rc2), 0.0))
    xr = SP._rows(x3).float()
    xr = torch.cat([xr, torch.ones(xr.shape[0], 1)], 1)
    acc = torch.zeros(dy1.shape[1], xr.shape[1])
    for r0 in range(0, dy1.shape[0], 16):
        acc = acc + (dy1[r0:r0 + 16].double().T
                     @ xr[r0:r0 + 16].double()).float()
    C0 = x3.shape[1]
    return acc[:, :C0], acc[:, C0]


# -- inputs ---------------------------------------------------------------

def _bench_setup(S, K, clouds=4):
    """bench.py's magnitudes: the model's SA weights at full width, randn
    clouds grouped (B1's twin) and centred; x and dpooled in bf16."""
    from facl_tpu_torch.ops import select as SEL
    from facl_tpu_torch.train import Trainer
    model = Trainer(cs._cfg(2), 100, device="cpu").init_state(cs.SEED).model
    layers = [SP.SALayerParams(*(t.detach() for t in lp))
              for lp in model.sa_stage.layers()]
    g = torch.Generator().manual_seed(cs.SEED)
    flat = torch.randn(clouds, 512, 4, generator=g)
    with torch.no_grad():
        grouped, _ = SEL.select_gather(flat, S, K, 0.06)
    grouped[:, :3] -= flat[:, :S, :3].transpose(1, 2)[..., None]
    x3 = grouped.reshape(clouds, 4, S * K)
    dp = torch.randn(clouds * S, 256, generator=g)
    return x3.to(BF16), layers, dp.to(BF16)


def _bench_inputs(S, K, clouds=4):
    """The bf16 chain from _bench_setup's inputs up to B2b's, B3a's, B3b's
    and B3c's inputs by the twins (chip_smoke.bf16_rows' chain)."""
    return _chain(*_bench_setup(S, K, clouds), K)


def _a12(xb, layers):
    """B2a's inputs: x, layers 1 and 2, layer 1's BatchNorm folded from
    Gram(x) (chip_smoke.bf16_rows' chain)."""
    lp1, lp2, _ = layers
    R = xb.shape[0] * xb.shape[2]
    xf = xb.float()
    m1, v1 = SP._moments_from_gram(torch.einsum("bcn,bdn->cd", xf, xf),
                                   xf.sum((0, 2)), lp1.kernel, lp1.bias, R)
    mul1, shift1 = _fold_affine(lp1, m1, v1, EPS)
    return xb, lp1.kernel, lp1.bias, mul1, shift1, lp2.kernel, lp2.bias


def _chain(xb, layers, dpb, K):
    lp1, lp2, lp3 = layers
    R = xb.shape[0] * xb.shape[2]
    a12 = _a12(xb, layers)
    mul1, shift1 = a12[3], a12[4]
    p2, s2, ss2 = SP.sa_fwd_layer12_bf16_plain(*a12)
    m2, v2 = _finalize(s2, ss2, R)
    mul2, shift2 = _fold_affine(lp2, m2, v2, EPS)
    agp = (p2, mul2, shift2, lp3.kernel, lp3.bias, K)
    G2, ch2, mx, mn, imx, imn = SP.sa_fwd_gram_pool_bf16_plain(*agp)
    m3, v3 = SP._moments_from_gram(G2, ch2, lp3.kernel, lp3.bias, R)
    mul3, shift3 = _fold_affine(lp3, m3, v3, EPS)
    sel = mul3 >= 0
    zstar = torch.where(sel, mx.float(), mn.float()) * mul3 + shift3
    idx = torch.where(zstar > 0, torch.where(sel, imx, imn),
                      torch.full_like(imx, K))
    gi2 = lp2.scale * torch.rsqrt(v2 + EPS)
    gi3 = lp3.scale * torch.rsqrt(v3 + EPS)
    as1 = (p2, mul2, shift2, dpb, idx, gi3, lp3.kernel, K)
    A3, u3, q3 = SP.sa_bwd_sweep1_bf16_plain(*as1)
    t3 = _layer_terms(A3, u3, lp3, m3, v3, G2, ch2, R, EPS)
    as2 = (xb, lp1.kernel, lp1.bias, mul1, shift1, p2, mul2, shift2, q3,
           t3["M"].contiguous(), t3["rc"], gi2, lp2.kernel)
    A2, G1, u2, ch1, mq = SP.sa_bwd_sweep2_bf16_plain(*as2)
    t2 = _layer_terms(A2, u2, lp2, m2, v2, G1, ch1, R, EPS)
    as3 = (xb, lp1.kernel, lp1.bias, mul1, shift1, mq, t2["M"].contiguous(),
           t2["rc"])
    return agp, as1, as2, as3


def _near_tie_inputs(rng, K=64, groups=64):
    """B2b's inputs with bf16 near-ties in every pool group: most rows a
    repeat of the group's last (a padded row, exact ties), a quarter of
    those nudged by one bf16 ulp of p2 (near-ties of p3)."""
    C2, C3 = 64, 256
    base = rng.normal(size=(groups, K, C2)).astype(np.float32)
    pad = rng.random(size=(groups, K)) < 0.7
    p2 = np.where(pad[..., None], base[:, -1:, :], base)
    p2 = torch.from_numpy(p2.reshape(-1, C2)).to(BF16)
    nudge = torch.from_numpy(
        (pad & (rng.random(size=(groups, K)) < 0.25)).reshape(-1))
    bits = p2.view(torch.int16)
    bits[nudge] += torch.tensor(1, dtype=torch.int16)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    return (p2, t(1.0 + 0.3 * rng.normal(size=C2)),
            t(0.2 * rng.normal(size=C2)), t(0.125 * rng.normal(size=(C2, C3))),
            t(0.1 * rng.normal(size=C3)), K)


# -- the model against the twins at phase 2's bf16 bars --------------------

def _layer12_within_bars(a12):
    model, twin = layer12_model(*a12), SP.sa_fwd_layer12_bf16_plain(*a12)
    cs.acc_rel(model[1], twin[1], "sum p2")
    cs.acc_rel(model[2], twin[2], "sum p2^2")
    return cs.bf16_flips(model[0], twin[0], "p2")[0]


def _gram_pool_within_bars(agp):
    model, twin = gram_pool_model(*agp), SP.sa_fwd_gram_pool_bf16_plain(*agp)
    p3 = cs.gram_pool_bf16_p3(*agp)
    cs.acc_rel(model[0], twin[0], "G2")
    cs.acc_rel(model[1], twin[1], "ch2")
    flips = cs.bf16_flips(model[2], twin[2], "max")[0] + \
        cs.bf16_flips(model[3], twin[3], "min")[0]
    ties = cs.bf16_index_flips(model[4], twin[4], p3, "argmax")[0] + \
        cs.bf16_index_flips(model[5], twin[5], p3, "argmin")[0]
    return flips, ties


def _sweep2_within_bars(as2):
    model, twin = sweep2_model(*as2), SP.sa_bwd_sweep2_bf16_plain(*as2)
    for a, b, name in zip(model[:4], twin[:4], ("A2", "G1", "u2", "ch1")):
        cs.acc_rel(a, b, name)
    return cs.bf16_flips(model[4], twin[4], "mq")[0]


def _sweep1_within_bars(as1):
    model, twin = sweep1_model(*as1), SP.sa_bwd_sweep1_bf16_plain(*as1)
    cs.acc_rel(model[0], twin[0], "A3")
    cs.acc_rel(model[1], twin[1], "u3")
    return cs.bf16_flips(model[2], twin[2], "q3")[0]


def _sweep3_within_bars(as3):
    model, twin = sweep3_model(*as3), SP.sa_bwd_sweep3_bf16_plain(*as3)
    cs.acc_rel(model[0], twin[0], "A1")
    cs.acc_rel(model[1], twin[1], "u1")


@pytest.mark.parametrize("S,K", [(64, 64), (32, 128)])
def test_layer12_model_within_phase2_bars_at_bench_magnitudes(S, K):
    xb, layers, _ = _bench_setup(S, K)
    _layer12_within_bars(_a12(xb, layers))


def test_layer12_model_within_phase2_bars_on_bf16_near_ties(rng):
    """B2a's inputs with bf16 near-ties: in each cloud most rows a repeat
    of its last (padded rows, exact ties), a quarter of those nudged by
    one bf16 ulp in channel 0, so that their p2 rows sit within an ulp of
    the padded row's."""
    Bc, C0_, N = 4, 4, 1024
    x = rng.normal(size=(Bc, C0_, N)).astype(np.float32)
    pad = rng.random(size=(Bc, N)) < 0.7
    pad[:, -1] = False                  # the padded row itself stays
    x = np.where(pad[:, None, :], x[:, :, -1:], x)
    xb = torch.from_numpy(x).to(BF16)
    nudge = torch.from_numpy(pad & (rng.random(size=(Bc, N)) < 0.25))
    ch0 = xb.view(torch.int16)[:, 0, :]
    ch0[nudge] += torch.tensor(1, dtype=torch.int16)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.normal(size=s)).astype(np.float32))
    a12 = (xb, f(C0_, 64, sc=0.5), f(64, sc=0.1),
           1.0 + f(64, sc=0.3), f(64, sc=0.1), f(64, 64, sc=0.125),
           f(64, sc=0.1))
    # the inputs do hold near-ties: a nudged row's p2 (f32, before its
    # rounding) within one bf16 ulp of its padded row's, and not equal
    h1 = SP._h1_bf16(*a12[:5])
    p2 = (SP._rb(h1 @ SP._rb(a12[5])) + SP._rb(a12[6])).view(Bc, N, 64)
    last = p2[:, -1:, :].expand_as(p2)[nudge]
    d = (p2[nudge] - last).abs()
    assert int(((d > 0) & (d <= cs.bf16_ulp(last.abs()))).sum()) > 100
    _layer12_within_bars(a12)


def test_layer12_h1_matches_the_recompute_chain_bit_for_bit():
    """B2a-bf16 makes h1 with two shortcuts that B3b-bf16 and B3c-bf16
    (h1_pre_bf16, relu_packed) do not take, and both give their values
    bit for bit. (1) Its sum x W1 starts from the first product where
    theirs adds it to +0: the two differ only in the sign of a zero sum,
    and the ReLU makes every zero +0. (2) Its ReLU is a 16-bit signed
    integer max with 0 on the bf16 bits, theirs keeps a half whose value
    is > 0: the same on every bf16 value but NaN."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    vals = bits.view(BF16).float()
    keep = ~torch.isnan(vals)
    relu_int = torch.clamp(bits, min=0)
    relu_packed = torch.where(vals > 0, bits, torch.zeros_like(bits))
    assert torch.equal(relu_int[keep], relu_packed[keep])

    rng = np.random.default_rng(3)
    C0_, N = 4, 4096
    x = rng.normal(size=(1, C0_, N)).astype(np.float32)
    x[:, :, ::4] = 0.0                  # rows of zeros: every term zero,
    x[:, 0, ::8] = -0.0                 # the first product's sign varies
    w1 = torch.from_numpy(rng.normal(size=(C0_, 64)).astype(np.float32))
    b1 = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    b1[::3] = -0.0                      # zeros of both signs carried on
    mul1 = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    shift1 = torch.from_numpy(rng.normal(size=64).astype(np.float32))
    shift1[::2] = 0.0
    shift1[::6] = -0.0
    xb = torch.from_numpy(x).to(BF16)

    def pre_relu(from_zero):
        xr, w = SP._rows(xb).float(), SP._rb(w1)
        a = xr[:, :1] * w[0]
        if from_zero:
            a = torch.zeros_like(a) + a
        for k in range(1, C0_):
            a = a + xr[:, k:k + 1] * w[k]
        p1 = SP._rb(a) + SP._rb(b1)
        return (p1 * mul1 + shift1).to(BF16).view(torch.int16)

    kernel, recompute = pre_relu(False), pre_relu(True)
    assert not torch.equal(kernel, recompute)   # signed zeros do differ
    assert torch.equal((kernel != recompute).nonzero(),
                       ((kernel & 0x7fff) == 0).logical_and(
                           kernel != recompute).nonzero())
    assert torch.equal(torch.clamp(kernel, min=0),
                       torch.clamp(recompute, min=0))


@pytest.mark.parametrize("S,K", [(64, 64), (32, 128)])
def test_model_within_phase2_bars_at_bench_magnitudes(S, K):
    agp, _, as2, _ = _bench_inputs(S, K)
    _gram_pool_within_bars(agp)
    _sweep2_within_bars(as2)


@pytest.mark.parametrize("S,K", [(64, 64), (32, 128)])
def test_sweep13_model_within_phase2_bars_at_bench_magnitudes(S, K):
    _, as1, _, as3 = _bench_inputs(S, K)
    _sweep1_within_bars(as1)
    _sweep3_within_bars(as3)


@pytest.mark.parametrize("K", [64, 128])
def test_sweep1_model_within_phase2_bars_on_skewed_argmax(rng, K):
    """The main path's argmax layout (chip_ablate.py's): 47% of a group's
    channels on its first row, 37% dead, the rest spread; at K = 128 a
    group spans two of the kernel's 64-row tiles. D's first row then
    holds ~120 values a group: its q3 row sums them all."""
    P, C2, C3 = 64, 64, 256
    R = P * K
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    u = rng.random(size=(P, C3))
    idx = np.where(u < 0.47, 0, np.where(u < 0.84, K,
                                         rng.integers(0, K, size=(P, C3))))
    assert (idx == 0).mean() > 0.4 and (idx == K).mean() > 0.3
    as1 = (t(rng.normal(size=(R, C2))).to(BF16),
           t(0.3 * rng.normal(size=C2)), t(rng.normal(size=C2)),
           t(rng.normal(size=(P, C3))).to(BF16),
           torch.from_numpy(idx.astype(np.int32)),
           t(1.0 + 0.3 * rng.normal(size=C3)),
           t(0.125 * rng.normal(size=(C2, C3))), K)
    _sweep1_within_bars(as1)


def test_model_within_phase2_bars_on_bf16_near_ties(rng):
    agp = _near_tie_inputs(rng)
    p3 = cs.gram_pool_bf16_p3(*agp)
    best = p3.amax(1, keepdim=True)
    gap = (best - p3) / cs.bf16_ulp(best.abs())
    # the inputs do hold near-ties: distinct values within one bf16 ulp
    # of a group's max
    assert int(((gap > 0) & (gap <= 1)).sum()) > 100
    _gram_pool_within_bars(agp)
    # B3b on the same rows: p2 with repeats and one-ulp nudges
    lp = [SP.SALayerParams(*(torch.from_numpy(a) for a in (
        rng.normal(size=(4, 64), scale=0.3).astype(np.float32),
        rng.normal(size=64, scale=0.1).astype(np.float32),
        (1.0 + 0.3 * rng.normal(size=64)).astype(np.float32),
        rng.normal(size=64, scale=0.1).astype(np.float32))))]
    R = agp[0].shape[0]
    x3 = torch.from_numpy(rng.normal(size=(2, 4, R // 2)).astype(
        np.float32)).to(BF16)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.normal(size=s)).astype(np.float32))
    as2 = (x3, lp[0].kernel, lp[0].bias, f(64, sc=2.0), f(64), agp[0],
           agp[1], agp[2], f(R, 64, sc=0.1).to(BF16), f(64, 64, sc=0.01),
           f(64, sc=0.1), f(64), f(64, 64, sc=0.125))
    _sweep2_within_bars(as2)


# -- the model against the JAX kernels (interpret mode) --------------------

@pytest.mark.parametrize("negative_scale", [False, True])
def test_layer12_model_matches_jax_sweep(rng, monkeypatch, negative_scale):
    """tests/test_torch_bf16_sa.py's shapes and tolerances: B2a's model fed
    the JAX side's own inputs, against the JAX kernel's p2 and sums."""
    x, layers = _setup(rng, negative_scale)
    store = []
    monkeypatch.setattr(jsp, "pl", _Recorder(store))
    Bt = x.shape[0]
    xf = jnp.asarray(x).astype(BF).reshape(Bt, C0, S_TINY * K_TINY)
    _, stats, *_ = jsp.sa_forward_pair(xf, layers, K_TINY, EPS, BF, True,
                                       True)
    m1, v1 = stats[0]
    mul1, shift1 = jax_fold_affine(layers[0], m1, v1, EPS)
    (w1, b1, _, _), (w2, b2, _, _) = (tuple(_t(a) for a in lp)
                                      for lp in layers[:2])
    x3 = torch.from_numpy(x).reshape(Bt, C0, S_TINY * K_TINY).to(BF16)
    p2, s2, ss2 = layer12_model(x3, w1, b1, _t(mul1), _t(shift1), w2, b2)
    r = store[0]
    C2 = WIDTHS[1]
    _bf16_rows(p2, _unpair(r[0], C2), "p2")
    _acc(s2, _lanes(r[1], C2), "sum p2")
    _acc(ss2, _lanes(r[2], C2), "sum p2^2")


@pytest.mark.parametrize("negative_scale", [False, True])
def test_model_matches_jax_sweeps(rng, monkeypatch, negative_scale):
    """tests/test_torch_bf16_sa.py's shapes and tolerances: B2b's and
    B3b's model fed the JAX side's own inputs."""
    x, layers = _setup(rng, negative_scale)
    store = []
    monkeypatch.setattr(jsp, "pl", _Recorder(store))
    Bt = x.shape[0]
    xf = jnp.asarray(x).astype(BF).reshape(Bt, C0, S_TINY * K_TINY)
    pooled, stats, p2p, gram2, idxp, gramx = jsp.sa_forward_pair(
        xf, layers, K_TINY, EPS, BF, True, True)
    C1, C2, C3 = WIDTHS
    dp = jnp.asarray(rng.normal(size=(Bt * S_TINY, C3)).astype(
        np.float32)).astype(BF)
    jsp.sa_backward_pair(xf, p2p, gram2, idxp, gramx, layers, stats, dp, EPS,
                         BF, True, True)
    n = Bt * S_TINY * K_TINY
    lp1, lp2, lp3 = layers
    (m1, v1), (m2, v2), (m3, v3) = stats
    mul1, shift1 = jax_fold_affine(lp1, m1, v1, EPS)
    mul2, shift2 = jax_fold_affine(lp2, m2, v2, EPS)
    gi2 = lp2.scale * jax.lax.rsqrt(v2 + EPS)
    (w1, b1, _, _), (w2, _, _, _), (w3, b3, _, _) = (
        tuple(_t(a) for a in lp) for lp in layers)
    x3 = torch.from_numpy(x).reshape(Bt, C0, S_TINY * K_TINY).to(BF16)
    jp2 = _unpair(store[0][0], C2).to(BF16)

    out = gram_pool_model(jp2, _t(mul2), _t(shift2), w3, b3, K_TINY)
    r = store[1]
    _acc(out[0], _fold2(r[0], C2, C2), "G2")
    _acc(out[1], _lanes(r[1], C2), "ch2")
    for i, name in enumerate(("max", "min")):
        _bf16_rows(out[2 + i], _unpair(r[2 + i], C3), name)
    for i, name in enumerate(("argmax", "argmin")):
        assert torch.equal(out[4 + i],
                           _unpair(r[4 + i], C3).to(torch.int32)), name

    r = store[2]
    jA3, ju3 = _fold2(r[0], C3, C2), _lanes(r[1], C3)
    t3 = jax_layer_terms(jnp.asarray(jA3.numpy()), jnp.asarray(ju3.numpy()),
                         lp3, m3, v3, gram2[0], gram2[1], n, EPS)
    A2, G1, u2, ch1, mq = sweep2_model(
        x3, w1, b1, _t(mul1), _t(shift1), jp2, _t(mul2), _t(shift2),
        _unpair(r[2], C2).to(BF16), _t(t3["M"]), _t(t3["rc"]), _t(gi2), w2)
    r = store[3]
    sums = _t(r[1])[0]
    for a, b_, name in (
            (A2, _fold2(r[0][:2 * C2], C2, C1), "A2"),
            (G1, _fold2(r[0][2 * C2:], C1, C1), "G1"),
            (u2, sums[:C2] + sums[C2:2 * C2], "u2"),
            (ch1, sums[2 * C2:2 * C2 + C1] + sums[2 * C2 + C1:], "ch1")):
        _acc(a, b_, name)
    _bf16_rows(mq, _unpair(r[2], C1), "mq")


@pytest.mark.parametrize("negative_scale", [False, True])
def test_sweep13_model_matches_jax_sweeps(rng, monkeypatch, negative_scale):
    """tests/test_torch_bf16_sa.py's shapes and tolerances: B3a's and
    B3c's model fed the JAX side's own inputs."""
    x, layers = _setup(rng, negative_scale)
    store = []
    monkeypatch.setattr(jsp, "pl", _Recorder(store))
    Bt = x.shape[0]
    xf = jnp.asarray(x).astype(BF).reshape(Bt, C0, S_TINY * K_TINY)
    pooled, stats, p2p, gram2, idxp, gramx = jsp.sa_forward_pair(
        xf, layers, K_TINY, EPS, BF, True, True)
    C1, C2, C3 = WIDTHS
    dp = jnp.asarray(rng.normal(size=(Bt * S_TINY, C3)).astype(
        np.float32)).astype(BF)
    jsp.sa_backward_pair(xf, p2p, gram2, idxp, gramx, layers, stats, dp, EPS,
                         BF, True, True)
    n = Bt * S_TINY * K_TINY
    lp1, lp2, lp3 = layers
    (m1, v1), (m2, v2), (m3, v3) = stats
    mul1, shift1 = jax_fold_affine(lp1, m1, v1, EPS)
    mul2, shift2 = jax_fold_affine(lp2, m2, v2, EPS)
    gi3 = lp3.scale * jax.lax.rsqrt(v3 + EPS)
    (w1, b1, _, _), _, (w3, _, _, _) = (tuple(_t(a) for a in lp)
                                        for lp in layers)
    x3 = torch.from_numpy(x).reshape(Bt, C0, S_TINY * K_TINY).to(BF16)
    jp2 = _unpair(store[0][0], C2).to(BF16)

    A3, u3, q3 = sweep1_model(jp2, _t(mul2), _t(shift2), _t(dp).to(BF16),
                              _unpair(idxp, C3).to(torch.int32), _t(gi3),
                              w3, K_TINY)
    r = store[2]
    jA3, ju3 = _fold2(r[0], C3, C2), _lanes(r[1], C3)
    _acc(A3, jA3, "A3")
    _acc(u3, ju3, "u3")
    _bf16_rows(q3, _unpair(r[2], C2), "q3")

    r = store[3]
    sums = _t(r[1])[0]
    jA2, jG1 = _fold2(r[0][:2 * C2], C2, C1), _fold2(r[0][2 * C2:], C1, C1)
    t2 = jax_layer_terms(jnp.asarray(jA2.numpy()),
                         jnp.asarray((sums[:C2] + sums[C2:2 * C2]).numpy()),
                         lp2, m2, v2, jnp.asarray(jG1.numpy()),
                         jnp.asarray((sums[2 * C2:2 * C2 + C1]
                                      + sums[2 * C2 + C1:]).numpy()), n, EPS)
    A1, u1 = sweep3_model(x3, w1, b1, _t(mul1), _t(shift1),
                          _unpair(r[2], C1).to(BF16), _t(t2["M"]),
                          _t(t2["rc"]))
    r = _t(store[4])
    _acc(A1, r[:C1, :C0] + r[C1:, C0:2 * C0], "A1")
    _acc(u1, r[:C1, 2 * C0] + r[C1:, 2 * C0], "u1")



# -- B8a at bf16 (sa_2sweep.cu bwd2_sweep1_kernel<true>) ------------------
# The kernel's order of sums: z^T = bf16(W3)^T h2^T in k16 steps into f32
# (_k16), p3 = bf16(that) + bf16(b3), the route on the f32 z; A3 = dy3^T
# h2 one 16-row k16 step at a time, each step summed on its own and added
# to the f32 running sums round-to-nearest, one block walking every row
# (the longest chain); u3 per 64-row tile as each lane sums its 16 rows
# (8 j + 2 t + e, j then e) in f32, carried in float64; Gram(h2) per tile
# in k16 steps into f32, the tiles added to f32 running sums; colsum(h2)
# per tile as each lane sums its 16 rows in pairs, the tiles added in f32,
# the lanes in float64; q3 = bf16(bf16(dy3 bf16(gi3)) bf16(W3)^T) in k16
# steps into f32.

def b8a_model(p2, mul2, shift2, w3, b3, mul3, shift3, gi3, dpooled,
              pool: int):
    """B8a-bf16 in the kernel's order of sums, with its twin's signature
    (ops/sa_bwd.py::sa_bwd2_sweep1_bf16_plain)."""
    from facl_tpu_torch.ops import sa_bwd as SB
    h2 = SB._h_bf16(p2, mul2, shift2)
    z = (SP._rb(_k16(h2, SP._rb(w3))) + SP._rb(b3)) * mul3 + shift3
    dy3 = SP._rb(SB._dy_top(z, dpooled.float(), pool))
    q3 = SP._rb(_k16(SP._rb(dy3 * SP._rb(gi3)), SP._rb(w3).T))
    R, C2, C3 = h2.shape[0], h2.shape[1], dy3.shape[1]
    A3 = torch.zeros(C3, C2)
    for r0 in range(0, R, 16):
        A3 = A3 + (dy3[r0:r0 + 16].double().T
                   @ h2[r0:r0 + 16].double()).float()
    lanes = dy3.view(-1, 8, 4, 2, C3)              # tile, j, t, e, channel
    su = torch.zeros(lanes.shape[0], 4, C3)
    for j in range(8):
        for e in range(2):
            su = su + lanes[:, j, :, e]
    u3 = su.double().sum((0, 1)).float()
    G2 = torch.zeros(C2, C2)
    ch = torch.zeros(4, C2)
    hl = h2.view(-1, 4, 2, 4, 2, C2)               # tile, kk, half, t, e, c
    for i in range(R // 64):
        ht = h2[64 * i:64 * i + 64]
        G2 = G2 + _k16(ht.T.contiguous(), ht)
        s = torch.zeros(4, C2)
        for kk in range(4):
            s = s + ((hl[i, kk, 0, :, 0] + hl[i, kk, 0, :, 1])
                     + (hl[i, kk, 1, :, 0] + hl[i, kk, 1, :, 1]))
        ch = ch + s
    return A3, u3, G2, ch.double().sum(0).float(), q3.to(BF16)


def _b8a_args(p2, mul2, shift2, w3, b3, mul3, shift3, gi3, dp, K):
    """B8a's arguments with dpooled zero on the near-tie pairs of the
    twin's f32 z (chip_smoke.two_sweep_bf16_rows' rule); the near-tie
    count."""
    from facl_tpu_torch.ops import sa_bwd as SB
    z = SB._z_bf16(SB._h_bf16(p2, mul2, shift2), w3, b3, mul3, shift3)
    near = cs.near_ties(z, K, 1e-5 * float(z.abs().max()))
    dp = torch.where(near, 0.0, dp.float()).to(BF16)
    return (p2, mul2, shift2, w3, b3, mul3, shift3, gi3, dp, K), \
        int(near.sum())


def _b8a_within_bars(as1):
    """The model against the bf16 twin at phase 2's bars: A3, u3, G2, ch2
    within ACC2_BAR of their max-abs, q3 within one bf16 ulp but at most
    1e-3 of its entries. Returns the q3 entries beyond one ulp."""
    from facl_tpu_torch.ops import sa_bwd as SB
    model, twin = b8a_model(*as1), SB.sa_bwd2_sweep1_bf16_plain(*as1)
    for a, b, name in zip(model[:4], twin[:4], ("A3", "u3", "G2", "ch2")):
        cs.acc_rel(a, b, name, cs.ACC2_BAR)
    return cs.bf16_flips(model[4], twin[4], "q3")[0]


def _b8a_bench_args(S, K, clouds=4):
    """B8a's arguments on hybrid2's bf16 forward of _bench_setup's inputs
    (chip_smoke.two_sweep_bf16_rows' chain)."""
    from facl_tpu_torch.ops import sa_fwd as SF
    xb, layers, dpb = _bench_setup(S, K, clouds)
    lp1, lp2, lp3 = layers
    R = xb.shape[0] * xb.shape[2]
    xr = xb.transpose(1, 2).reshape(R, xb.shape[1]).contiguous()
    p1, s1, ss1 = SF.sa_fwd_layer_bf16_plain(xr, lp1.kernel, lp1.bias)
    mul1, shift1 = _fold_affine(lp1, *_finalize(s1, ss1, R), EPS)
    p2, s2, ss2 = SF.sa_fwd_layer_bf16_plain(p1, lp2.kernel, lp2.bias, mul1,
                                             shift1)
    m2, v2 = _finalize(s2, ss2, R)
    mul2, shift2 = _fold_affine(lp2, m2, v2, EPS)
    G2, ch2 = SF.sa_fwd_gram_bf16_plain(p2, mul2, shift2)
    m3, v3 = SF._moments_from_gram(G2, ch2, lp3.kernel, lp3.bias, R)
    mul3, shift3 = _fold_affine(lp3, m3, v3, EPS)
    gi3 = lp3.scale * torch.rsqrt(v3 + EPS)
    return _b8a_args(p2, mul2, shift2, lp3.kernel, lp3.bias, mul3, shift3,
                     gi3, dpb, K)[0]


@pytest.mark.parametrize("S,K", [(64, 64), (32, 128)])
def test_b8a_model_within_phase2_bars_at_bench_magnitudes(S, K):
    _b8a_within_bars(_b8a_bench_args(S, K))


@pytest.mark.parametrize("K", [64, 128])
def test_b8a_model_within_phase2_bars_on_padded_groups(rng, K):
    """Groups padded with copies of their first row: the tied rows' z are
    bit-identical in the model (their h2 rows are), so each routed pair
    splits its cotangent over ~K/2 rows, as the main path's ~25."""
    from facl_tpu_torch.ops import sa_bwd as SB
    groups = 48
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.normal(size=s)).astype(np.float32))
    p2 = torch.from_numpy(padded_groups(rng, groups * K, K)).to(BF16)
    as1, _ = _b8a_args(p2, f(64, sc=0.3), f(64),
                       f(64, 256, sc=0.125), f(256, sc=0.1), f(256, sc=0.2),
                       f(256), 1.0 + f(256, sc=0.3), f(groups, 256), K)
    h2 = SB._h_bf16(*as1[:3])
    dy3 = SB._dy_top(SB._z_bf16(h2, *as1[3:7]), as1[8].float(), K)
    routed = int((dy3.view(groups, K, 256) != 0).any(1).sum())
    assert int((dy3 != 0).sum()) >= 5 * routed     # ties a routed pair
    _b8a_within_bars(as1)


def test_b8a_model_within_phase2_bars_on_bf16_near_ties(rng):
    """_near_tie_inputs' p2 (padded rows repeated, a quarter nudged by one
    bf16 ulp): distinct p3 within one bf16 ulp of a group's max, where
    the model's k16 order and the twin's may round apart."""
    p2, mul2, shift2, w3, b3, K = _near_tie_inputs(rng)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.normal(size=s)).astype(np.float32))
    P = p2.shape[0] // K
    p3 = cs.gram_pool_bf16_p3(p2, mul2, shift2, w3, b3, K)
    best = p3.amax(1, keepdim=True)
    gap = (best - p3) / cs.bf16_ulp(best.abs())
    assert int(((gap > 0) & (gap <= 1)).sum()) > 100
    as1, _ = _b8a_args(p2, mul2, shift2, w3, b3, 1.0 + f(256, sc=0.3),
                       f(256, sc=0.1), 1.0 + f(256, sc=0.3), f(P, 256), K)
    _b8a_within_bars(as1)


@pytest.mark.parametrize("negative_scale", [False, True])
def test_b8a_model_matches_jax_sweep(rng, monkeypatch, negative_scale):
    """tests/test_torch_bf16_sa.py's shapes and tolerances: B8a's model fed
    the JAX side's own inputs (hybrid2's forward at bf16, its p2 and
    statistics), against the JAX sweep 1 of sa_backward_pallas in
    interpret mode: its packed [dy3 | h2]^T [h2 | ones] and q3."""
    import facl_tpu.ops.pallas.sa_bwd as jsb
    import facl_tpu.ops.pallas.sa_fwd as jsf
    from tests.test_torch_bf16_sa import B as B_TINY
    store = []
    monkeypatch.setattr(jsf, "pl", _Recorder(store))
    monkeypatch.setattr(jsb, "pl", _Recorder(store))
    x, layers = _setup(rng, negative_scale)
    rows = x.transpose(0, 2, 3, 1).reshape(-1, C0)
    xf = jnp.asarray(rows).astype(BF)
    _, stats, jp1, jp2 = jsf.sa_forward_pallas(xf, layers, K_TINY, EPS, BF,
                                               True)
    C1, C2, C3 = WIDTHS
    dp = jnp.asarray(rng.normal(size=(B_TINY * S_TINY, C3)).astype(
        np.float32)).astype(BF)
    jsb.sa_backward_pallas(xf, jp1, jp2, layers, stats, dp, EPS, BF, True)
    assert len(store) == 6            # layer x2, gram, pool, sweeps 1-2
    _, lp2, lp3 = layers
    (_, _), (m2, v2), (m3, v3) = stats
    mul2, shift2 = (_t(a) for a in jax_fold_affine(lp2, m2, v2, EPS))
    mul3, shift3 = (_t(a) for a in jax_fold_affine(lp3, m3, v3, EPS))
    gi3 = _t(lp3.scale * jax.lax.rsqrt(v3 + EPS))
    w3, b3 = _t(lp3.kernel), _t(lp3.bias)
    A3, u3, G2, ch2, q3 = b8a_model(
        _t(store[1][0]).to(BF16), mul2, shift2, w3, b3, mul3, shift3, gi3,
        _t(dp).to(BF16), K_TINY)
    out1, jq3 = _t(store[4][0]), _t(store[4][1])
    for a, b_, name in ((A3, out1[:C3, :C2], "A3"), (u3, out1[:C3, C2], "u3"),
                        (G2, out1[C3:, :C2], "G2"),
                        (ch2, out1[C3:, C2], "ch2")):
        _acc(a, b_, name)
    _bf16_rows(q3, jq3, "q3")

# -- chip_smoke.py --parent: a bf16 sweep against the parent's ------------

def _pool_case(rng, P=40, K=64, C=256):
    """A parent's B2b-bf16 outputs (G2, ch2, max, min, argmax, argmin) and
    the twin's f32 p3 they were taken from."""
    p3 = torch.from_numpy(rng.normal(size=(P, K, C)).astype(np.float32))
    mx, mn = p3.amax(1), p3.amin(1)
    out = [torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)),
           torch.from_numpy(rng.normal(size=64).astype(np.float32)),
           mx.to(BF16), mn.to(BF16), SP._first_index(p3, mx, K),
           SP._first_index(p3, mn, K)]
    return p3, out


def _one_ulp(t, where, n=1):
    """t (bf16) moved by n bf16 ulps at ``where``."""
    bits = t.clone().view(torch.int16)
    bits[where] += torch.tensor(n, dtype=torch.int16)
    return bits.view(BF16)


@pytest.mark.parametrize("case", ["equal", "one-ulp", "flips-within-bar",
                                  "near-tie-index", "accumulator-within"])
def test_parent_bf16_comparison_passes_within_bars(rng, case):
    p3, theirs = _pool_case(rng)
    mine = [t.clone() for t in theirs]
    P, C = mine[2].shape
    if case == "one-ulp":           # every entry one ulp off: not a flip
        mine[2] = _one_ulp(mine[2], torch.ones(P, C, dtype=torch.bool))
    elif case == "flips-within-bar":   # 2-ulp flips in 1e-3 of the entries
        sel = torch.zeros(P * C, dtype=torch.bool)
        sel[:int(1e-3 * P * C)] = True
        mine[3] = _one_ulp(mine[3], sel.view(P, C), 2)
    elif case == "near-tie-index":  # the max moved to a row within one ulp
        g, c = 3, 7
        i = int(theirs[4][g, c])
        j = (i + 5) % p3.shape[1]
        p3[g, j, c] = p3[g, i, c] - cs.bf16_ulp(p3[g, i, c].abs()) / 2
        mine[4][g, c] = j
    elif case == "accumulator-within":
        mine[0] = mine[0] + 0.5e-3 * float(mine[0].abs().max())
    note = cs.bf16_vs_parent("sa_fwd_gram_pool_bf16", mine, theirs, p3)
    assert isinstance(note, str)


@pytest.mark.parametrize("case", ["flips-beyond-bar", "far-index",
                                  "accumulator-beyond", "dtype"])
def test_parent_bf16_comparison_fails_beyond_bars(rng, case):
    p3, theirs = _pool_case(rng)
    mine = [t.clone() for t in theirs]
    P, C = mine[2].shape
    if case == "flips-beyond-bar":   # 2-ulp flips in 2e-3 of the entries
        sel = torch.zeros(P * C, dtype=torch.bool)
        sel[:int(2e-3 * P * C) + 1] = True
        mine[2] = _one_ulp(mine[2], sel.view(P, C), 2)
    elif case == "far-index":       # the max moved to a row far below it
        g, c = 3, 7
        i = int(theirs[4][g, c])
        j = int(p3[g, :, c].argmin())
        assert i != j
        mine[4][g, c] = j
    elif case == "accumulator-beyond":
        mine[1] = mine[1] + 2e-3 * float(mine[1].abs().max())
    elif case == "dtype":           # an f32 max where the parent's is bf16
        mine[2] = mine[2].float()
    with pytest.raises(SystemExit):
        cs.bf16_vs_parent("sa_fwd_gram_pool_bf16", mine, theirs, p3)


# -- chip_smoke.py's profiled kernel time ----------------------------------

def test_kernel_ms_leaves_out_user_annotations():
    """kernel_ms sums the device events by name but user annotations: the
    device range of ``Optimizer.step#Adam.step`` spans Adam's kernels and
    the gaps between them; host-side events are not counted."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import FunctionEvent

    def ev(i, name, start, end, device=DeviceType.CUDA, annotation=False):
        return FunctionEvent(id=i, name=name, thread=0, start_us=start,
                             end_us=end, device_type=device,
                             use_device="cuda", is_user_annotation=annotation)
    events = [ev(0, "Optimizer.step#Adam.step", 0, 1000, annotation=True),
              ev(1, "adam_kernel", 100, 300), ev(2, "adam_kernel", 600, 700),
              ev(3, "gemm", 1000, 1500),
              ev(4, "Optimizer.step#Adam.step", 0, 1200, DeviceType.CPU,
                 annotation=True),
              ev(5, "aten::mm", 0, 50, DeviceType.CPU)]
    kern = cs.kernel_ms(events)
    assert kern == pytest.approx({"adam_kernel": 0.3, "gemm": 0.5})
    assert sum(kern.values()) == pytest.approx(0.8)


# -- B9 at bf16 (sa_fused.cu's sa_fused_bf16_kernel) -----------------------
# The kernel's order of sums: p = bf16(h W) by the k-order chain (fwd_mma's
# sums near a bf16 rounding boundary are redone in k order; the rest fell
# on the chain's bf16 value in every sum measured, chip_ablate.py tc_sums:
# the model takes the chain for all), but a stats sweep's own layer (only
# summed) in k16 steps (_k16); da = bf16(dp)
# W^T in k16 steps into f32 (_k16); dW = h^T dp with dp as three bf16
# pieces, each 16-row step's three products (lo, mid, hi) added to the
# tile's f32 sum, the 128-row tiles added in f32 and carried to float64
# every 32 tiles; column sums over each 128-row tile by eight row slices
# (rows q, q + 8, ..) in f32, the slices and tiles in float64; dx = dp0
# W0^T fused-multiply-added in c order. One block walks every tile (the
# card's blocks split them; their float64 partials add in block order).

TR9, DW_FLUSH9 = 128, 32


def _kseq(h, w):
    """h (m, k) @ w (k, n) of bf16 values as the k-order chain sums them:
    from 0, k ascending, each exact product added and rounded in f32."""
    acc = torch.zeros(h.shape[0], w.shape[1])
    for k in range(h.shape[1]):
        acc = acc + h[:, k:k + 1] * w[k]
    return acc


def _tiles9(a, step):
    """a (R, C) zero-padded to whole 128-row tiles: (tiles, 128 / step,
    step, C). Rows past R add exact zeros, as the kernel's empty rows."""
    a = torch.cat([a, a.new_zeros((-a.shape[0]) % TR9, a.shape[1])])
    return a.reshape(-1, TR9 // step, step, a.shape[1])


def _colsum9(a):
    """Column sums as colsums_bf: each 128-row tile's eight row slices in
    f32 (rows in order), the slices and the tiles in float64."""
    t = _tiles9(a, 8)
    s = torch.zeros(t.shape[0], 8, t.shape[3])
    for i in range(t.shape[1]):
        s = s + t[:, i]
    return s.double().sum((0, 1)).float()


def _split3(d):
    """dp's three bf16 pieces: hi + mid + lo == dp exactly."""
    hi = SK._rb(d)
    mid = SK._rb(d - hi)
    lo = SK._rb(d - hi - mid)
    assert torch.equal(hi + mid + lo, d)
    return lo, mid, hi


def _dw9(h, d):
    """dW = h^T d as dw_mma sums it (a 16-row step's product of exact bf16
    values summed in float64 and added to the tile's f32 sum)."""
    hs = _tiles9(h, 16).double().transpose(2, 3)
    pieces = [_tiles9(p, 16).double() for p in _split3(d)]
    st = torch.zeros(hs.shape[0], h.shape[1], d.shape[1])
    for i in range(hs.shape[1]):
        for piece in pieces:
            st = (st.double() + hs[:, i] @ piece[:, i]).float()
    out = torch.zeros(st.shape[1:], dtype=torch.float64)
    run = torch.zeros(st.shape[1:])
    for i in range(st.shape[0]):
        run = run + st[i]
        if (i + 1) % DW_FLUSH9 == 0:
            out += run.double()
            run = torch.zeros_like(run)
    return (out + run.double()).float()


def _dx9(dp, w0t):
    """dx = dp0 W0^T as dx_part: fmaf over c in order, from 0."""
    acc = torch.zeros(dp.shape[0], w0t.shape[1])
    for c in range(dp.shape[1]):
        acc = (acc.double() + dp[:, c:c + 1].double() *
               w0t[c].double()).float()
    return acc


def _forward9(x, layers, v, upto):
    """Layers < upto as the kernel computes them (p by the k-order chain)."""
    rb = SK._rb
    ps, hs = [], [rb(x)]
    for l in range(upto):
        w = layers[l].kernel.shape[1]
        p = rb(_kseq(hs[-1], rb(layers[l].kernel))) + v[l, 0, :w]
        ps.append(p)
        hs.append(torch.relu(rb(p * v[l, 3, :w] + v[l, 4, :w])))
    return ps, hs


def _backward9(x, layers, v, dout, pool, target, need_dx):
    rb, L = SK._rb, len(layers)
    ps, hs = _forward9(x, layers, v, L)
    da = SK._pool_grad(hs.pop(), dout, pool)
    dws, dbs = [None] * L, [None] * L
    for l in range(L - 1, -1, -1):
        w = layers[l].kernel.shape[1]
        p = ps.pop()
        dy = torch.where(rb(p * v[l, 3, :w] + v[l, 4, :w]) > 0, da, 0.0)
        xh = p * v[l, 1, :w] + v[l, 2, :w]
        if l == target:
            return _colsum9(dy), _colsum9(dy * xh)
        dp = v[l, 5, :w] * ((dy - v[l, 6, :w]) - xh * v[l, 7, :w])
        dws[l], dbs[l] = _dw9(hs[l], dp), _colsum9(dp)
        if l:
            da = _k16(rb(dp), rb(layers[l].kernel).T)
        elif need_dx:
            da = _dx9(dp, layers[l].kernel.T.contiguous())
    return (da if need_dx else None), dws, dbs


def fused_model(sweep):
    """B9-bf16's sweep ``sweep`` (stats, pool, bnsum, final) in the
    kernel's order of sums, with its wrapper's signature and name."""
    def stats(x, layers, packed, pool, target, prm=None):
        v = SK.vectors(layers, packed, None, x.shape[0], True)
        hs = _forward9(x, layers, v, target)[1]
        w = layers[target].kernel.shape[1]
        rw = SK._rb(layers[target].kernel)
        p = SK._rb(_k16(hs[-1], rw) if target else _kseq(hs[-1], rw)) + \
            v[target, 0, :w]
        return _colsum9(p), _colsum9(p * p)

    def pool_(x, layers, packed, pool, prm=None):
        v = SK.vectors(layers, packed, None, x.shape[0], True)
        h = _forward9(x, layers, v, len(layers))[1][-1]
        return h.reshape(-1, pool, h.shape[1]).amax(1)

    def bnsum(x, layers, packed, bsums, dout, pool, target, prm=None):
        v = SK.vectors(layers, packed, bsums, x.shape[0], True)
        return _backward9(x, layers, v, dout, pool, target, False)

    def final(x, layers, packed, bsums, dout, pool, need_dx=True, prm=None):
        v = SK.vectors(layers, packed, bsums, x.shape[0], True)
        return _backward9(x, layers, v, dout, pool, -1, need_dx)
    fn = {"stats": stats, "pool": pool_, "bnsum": bnsum, "final": final}[sweep]
    fn.__name__ = f"sa_fused_{sweep}_bf16"
    return fn


@contextlib.contextmanager
def _with_fused_model():
    """The four bf16 B9 wrappers replaced by the model (their twins kept):
    chip_smoke.b9_bf16_rows then holds the model at phase 2's bars. On one
    intra-op thread: the model's many whole-tensor passes slow down tenfold
    and more when the test workers oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with cs.swapped([(SK, f"sa_fused_{n}_bf16", fused_model(n))
                         for n in ("stats", "pool", "bnsum", "final")]):
            yield
    finally:
        torch.set_num_threads(threads)


def _b9_bench_rows(S, K, clouds):
    xb, layers, dp = _bench_setup(S, K, clouds)
    xr = xb.float().transpose(1, 2).reshape(-1, 4).contiguous()
    return xr, list(layers), dp.float()


@pytest.mark.parametrize("S,K", [(64, 64), (32, 128)])
def test_fused_model_within_b9_bf16_bars_at_bench_magnitudes(S, K):
    """The model of B9-bf16's eight launches against the bf16 twins at
    chip_smoke.py's B9 bf16 bars (b9_bf16_rows: pooled bit-equal outside
    the bf16 near-tie pairs, accumulators within B9_BF16_BAR, dx rows
    counted, run to run equal), on bench.py's magnitudes."""
    xr, layers, dp = _b9_bench_rows(S, K, 4)
    with _with_fused_model():
        rows = cs.b9_bf16_rows(xr, layers, K, dp)
    assert len(rows) == 8


def test_fused_model_within_b9_bf16_bars_on_bf16_near_ties():
    """The same on rows with bf16 near-ties: in each group most rows a
    repeat of its last (exact ties), a quarter of those nudged by one bf16
    ulp in channel 0, so that their top-layer values sit within an ulp of
    the group's max."""
    K = 64
    xr, layers, dp = _b9_bench_rows(32, K, 2)
    g = torch.Generator().manual_seed(5)
    rows = xr.reshape(-1, K, 4)
    pad = torch.rand(rows.shape[:2], generator=g) < 0.7
    rows = torch.where(pad[..., None], rows[:, -1:, :], rows)
    nudge = pad & (torch.rand(pad.shape, generator=g) < 0.25)
    x0 = rows[..., 0].to(BF16)
    bits = x0.view(torch.int16)
    bits[nudge] += torch.tensor(1, dtype=torch.int16)
    rows = torch.cat([x0.float()[..., None], rows[..., 1:]], -1)
    xr = rows.reshape(-1, 4).contiguous()
    assert int(nudge.sum()) > 100
    with _with_fused_model():
        cs.b9_bf16_rows(xr, layers, K, dp)


@pytest.mark.parametrize("widths,ties", [((8, 16, 32), False),
                                         ((8, 16, 32), True),
                                         ((16, 32), False)])
def test_fused_model_matches_jax_sweeps(rng, monkeypatch, widths, ties):
    """tests/test_torch_bf16_fused.py's shapes and tolerances: the model of
    each bf16 sweep against the JAX kernel's (multi-call form, interpret
    mode) fed the JAX side's statistics, BN sums and cotangent."""
    from tests.test_torch_bf16_fused import _acc as _acc5, _layers as \
        _layers5, _rows as _rows5
    R, K, L = 256, 8, len(widths)
    x = _rows5(rng, R, K, ties)
    jl, tl = _layers5(rng, widths)
    store = []
    monkeypatch.setattr(jsk, "pl", _Recorder(store))
    _, _, packed = jsk.sa_train_forward_pallas(jnp.asarray(x), jl, K, EPS,
                                               BF, True)
    dout = jnp.asarray(rng.normal(size=(R // K, widths[-1])).astype(
        np.float32)).astype(BF).astype(jnp.float32)
    jsk.sa_train_backward_pallas(jnp.asarray(x), jl, packed, dout, K, EPS,
                                 BF, True, True)
    assert len(store) == 2 * L + 2
    xt, packed, dout = torch.from_numpy(x), _t(packed), _t(dout)
    layers = [SK.SALayerParams(*(t.detach() for t in lp)) for lp in tl]
    for l in range(L):
        s, ss = fused_model("stats")(xt, layers, packed, K, l)
        _acc5(s, store[l][0], f"sum p{l}")
        _acc5(ss, store[l][1], f"sum p{l}^2")
    _bf16_rows(fused_model("pool")(xt, layers, packed, K), _t(store[L]),
               "pooled")
    bsums = torch.zeros_like(packed)
    for j, l in enumerate(reversed(range(L))):
        s_dy, s_dyx = fused_model("bnsum")(xt, layers, packed, bsums, dout,
                                           K, l)
        r = _t(store[L + 1 + j])
        _acc5(s_dy, r[0], f"sum dy{l}")
        _acc5(s_dyx, r[1], f"sum dy xhat{l}")
        bsums[l, 0, :widths[l]], bsums[l, 1, :widths[l]] = r[0], r[1]
    dx, dws, dbs = fused_model("final")(xt, layers, packed, bsums, dout, K)
    r = [_t(a) for a in store[-1]]
    _acc5(dx, r[0], "dx")
    for l in range(L):
        _acc5(dws[l], r[1 + l], f"dW{l}")
        _acc5(dbs[l], r[1 + L + l][0], f"db{l}",
              scale=float(r[1 + l].abs().max()))


def test_dw_split_is_exact_and_f32_level():
    """dW's three bf16 pieces of dp sum to dp exactly, and the split
    product is as close to float64 as an f32 product (h exact in bf16)."""
    g = torch.Generator().manual_seed(3)
    h = SK._rb(torch.relu(torch.randn(1024, 64, generator=g)))
    d = torch.randn(1024, 256, generator=g) * 1e-3
    ref = h.double().T @ d.double()
    err = float((_dw9(h, d).double() - ref).abs().max())
    f32 = float(((h.T @ d).double() - ref).abs().max())
    assert err <= 4 * f32 + 1e-12, (err, f32)


def _b9_parent_case(rng, R=4096, C0=4, P=64, C=256):
    """A parent's bf16 B9 final-sweep and pool outputs."""
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    pooled = t(P, C).to(BF16).float()
    final = [t(R, C0), t(C0, 64), t(64, 64), t(64, C), 1e-6 * t(64),
             1e-6 * t(64), 1e-6 * t(C)]   # db: round-off of a zero
    return pooled, final


@pytest.mark.parametrize("case", ["equal", "pooled-one-ulp", "dx-rows-within",
                                  "accumulator-within"])
def test_b9_bf16_parent_comparison_passes_within_bars(rng, case):
    pooled, theirs = _b9_parent_case(rng)
    mine, mpool = [t.clone() for t in theirs], pooled.clone()
    if case == "pooled-one-ulp":
        mpool = _one_ulp(pooled.to(BF16), torch.ones_like(
            pooled, dtype=torch.bool)).float()
    elif case == "dx-rows-within":
        mine[0][:4] *= 1.01              # 4 of 4096 rows: within 1e-3
    elif case == "accumulator-within":
        mine[3] = mine[3] + 1e-4 * float(mine[3].abs().max())
        mine[4] = 100 * mine[4]          # db: another round-off, still ~0
    assert isinstance(cs.b9_bf16_vs_parent("sa_fused_final_bf16", mine,
                                           theirs), str)
    assert isinstance(cs.b9_bf16_vs_parent("sa_fused_pool_bf16", [mpool],
                                           [pooled]), str)


@pytest.mark.parametrize("case", ["dx-rows-beyond", "accumulator-beyond",
                                  "pooled-flips-beyond", "db-not-near-zero"])
def test_b9_bf16_parent_comparison_fails_beyond_bars(rng, case):
    pooled, theirs = _b9_parent_case(rng)
    mine = [t.clone() for t in theirs]
    with pytest.raises(SystemExit):
        if case == "dx-rows-beyond":
            mine[0][:5] *= 1.01          # 5 of 4096 rows: beyond 1e-3
            cs.b9_bf16_vs_parent("sa_fused_final_bf16", mine, theirs)
        elif case == "accumulator-beyond":
            mine[2] = mine[2] + 1e-3 * float(mine[2].abs().max())
            cs.b9_bf16_vs_parent("sa_fused_final_bf16", mine, theirs)
        elif case == "db-not-near-zero":
            mine[5] = mine[5] + 1e-3 * float(mine[3].abs().max())
            cs.b9_bf16_vs_parent("sa_fused_final_bf16", mine, theirs)
        else:
            P, C = pooled.shape
            sel = torch.zeros(P * C, dtype=torch.bool)
            sel[:int(2e-3 * P * C) + 1] = True
            mpool = _one_ulp(pooled.to(BF16), sel.view(P, C), 2).float()
            cs.b9_bf16_vs_parent("sa_fused_pool_bf16", [mpool], [pooled])
