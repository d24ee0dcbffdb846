"""The order of sums of the bf16 B8b (sa_bwd2_sweep2_bf16, h1 from the
stored p1) and B6 (sa_bwd_sweep2_full_bf16, h1 from x) on the tensor
cores, modelled in torch on the CPU (``sweep2_bf16_model``,
``sweep2_full_bf16_model``, with the twins' signatures), held against
their bf16 twins (ops/sa_bwd.py::_sweep2_bf16) and against the JAX sweeps
they port, run in interpret mode.

On the card (facl_tpu_torch/ops/csrc/sa_2sweep.cu, bwd2_sweep2_bf16_kernel)
every product takes two bf16 operands and is exact in f32: h2 bf16(M3)
and q2 in k16 steps into f32, as B3b; the contraction over rows, [dy2 | h1
| m1 | m1 x_i]^T h1 and [dy2 | m1 | mq | h1 | x]^T [x | 1], one 16-row k16
step at a time into the mma's f32 accumulators, which are added to float64
every S2F_FLUSH = 32 steps of 128 rows (4,096 rows). The models sum in
that order (a k16 step summed in float64 and rounded to f32, then added
to the f32 accumulator; one block walking every row: the longest chains),
the rest as the twins cast it; B6's h1 by its k-order chain
(test_torch_bf16_mma_order._h1_chain, the kernel's h1_pre_bf16). So the
bars the card is held to can be checked against that order here:

  * at bench.py's magnitudes (the model's SA weights at full width, randn
    clouds grouped at S = K = 64 and at the fine variant's S = 32, K =
    128, through hybrid2's and pair's bf16 twins) and on rows whose p1 or
    p2 sits one bf16 ulp from the ReLU threshold, each model sits within
    chip_smoke.py phase 2's ACC2_BAR of the twin's max-abs, cnt1 exact;
  * on tests/test_torch_bf16_sa.py's tiny shapes at C0 = 1, 4 and 7 it
    sits within that file's tolerances of the JAX sweeps (facl_tpu/ops/
    pallas/sa_bwd.py pallas_call :298, sa_pair.py :863).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facl_tpu.ops.pallas.sa_bwd as jsb
import facl_tpu.ops.pallas.sa_fwd as jsf
import facl_tpu.ops.pallas.sa_pair as jsp
from facl_tpu.ops.pallas.sa_bwd import _fold_affine as jax_fold_affine
from facl_tpu.ops.pallas.sa_bwd import _layer_terms as jax_layer_terms
from facl_tpu_torch.ops import sa_bwd as SB
from facl_tpu_torch.ops import sa_fwd as SF
from facl_tpu_torch.ops import sa_pair as SP
from facl_tpu_torch.ops.sa_bwd import _fold_affine, _layer_terms
from facl_tpu_torch.ops.sa_fwd import _finalize
from tests.test_analytic_sa import make_layers
from tests.test_torch_bf16_mma_order import _bench_inputs, _bench_setup, \
    _h1_chain, _k16, cs
from tests.test_torch_bf16_sa import B as B_TINY, EPS, K as K_TINY, \
    S as S_TINY, WIDTHS, BF, _acc, _fold2, _lanes, _Recorder, _t, _unpair

BF16 = torch.bfloat16
#: Rows between the card's float64 adds (S2F_FLUSH steps of 128 rows).
FLUSH_ROWS = 32 * 128


# -- the models -------------------------------------------------------------

def _rows_sum(a, b, chunk=FLUSH_ROWS):
    """a^T b over rows as the card sums it: each 16-row k16 step summed
    exactly (float64) and rounded to f32, the steps added to an f32
    accumulator in row order, the accumulator added to float64 every
    ``chunk`` rows."""
    R = a.shape[0]
    steps = (a.double().view(R // 16, 16, -1).transpose(1, 2)
             @ b.double().view(R // 16, 16, -1)).float()
    out = torch.zeros(a.shape[1], b.shape[1], dtype=torch.float64)
    per = chunk // 16
    for c0 in range(0, R // 16, per):
        acc = torch.zeros(a.shape[1], b.shape[1])
        for s in steps[c0:c0 + per]:
            acc = acc + s
        out += acc.double()
    return out.float()


def _sweep2_model(x, h1, p2, mul2, shift2, q3, M3, rc3, gi2, w2):
    """The accumulators of ops/sa_bwd.py::_sweep2_bf16 in the card's order
    from x (R, C0) and h1 (f32 holding bf16 values)."""
    rb = SB._rb
    h2 = SB._h_bf16(p2, mul2, shift2)
    dy2 = rb(torch.where(h2 > 0, q3.float() - rb(_k16(h2, rb(M3))) - rc3,
                         0.0))
    q2 = rb(_k16(rb(dy2 * rb(gi2)), rb(w2).T))
    m1 = (h1 > 0).float()
    mq = torch.where(h1 > 0, q2, 0.0)
    C0 = x.shape[1]
    xo = torch.cat([x, torch.ones(x.shape[0], 1)], 1)
    d, mm, q, hh, xx = (_rows_sum(a, xo) for a in (dy2, m1, mq, h1, x))
    return dict(A2=_rows_sum(dy2, h1), u2=d[:, C0], G1=_rows_sum(h1, h1),
                ch1=hh[:, C0], cnt1=mm[:, C0], acc1=q[:, C0],
                T1x=mm[:, :C0], P1=q[:, :C0], Gx=xx[:, :C0], cx=xx[:, C0],
                TM1=_rows_sum(m1, h1),
                U1=torch.stack([_rows_sum(m1 * x[:, i:i + 1], h1)
                                for i in range(C0)], -1))


def sweep2_bf16_model(x, p1, mul1, shift1, p2, mul2, shift2, q3, M3, rc3,
                      gi2, w2):
    """B8b-bf16 in the card's order of sums, with its twin's signature
    (ops/sa_bwd.py::sa_bwd2_sweep2_bf16_plain)."""
    return _sweep2_model(x.float(), SB._h_bf16(p1, mul1, shift1), p2, mul2,
                         shift2, q3, M3, rc3, gi2, w2)


def sweep2_full_bf16_model(x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3,
                           M3, rc3, gi2, w2):
    """B6-bf16 in the card's order of sums, with its twin's signature
    (ops/sa_pair.py::sa_bwd_sweep2_full_bf16_plain): h1 by the kernel's
    k-order chain."""
    return _sweep2_model(SP._rows(x3).float(),
                         _h1_chain(x3, w1, b1, mul1, shift1), p2, mul2,
                         shift2, q3, M3, rc3, gi2, w2)


# -- against the twins at phase 2's bars -----------------------------------

def _within_bars(model, twin, args):
    """The model against the twin: cnt1 exact, every accumulator within
    ACC2_BAR of the twin's max-abs. Returns the twin's outputs."""
    m, t = model(*args), twin(*args)
    assert set(m) == set(t)
    assert torch.equal(m["cnt1"], t["cnt1"])
    for n in t:
        cs.acc_rel(m[n], t[n], n, cs.ACC2_BAR)
    return t


def _b8b_bench_args(S, K, clouds=4):
    """B8b's arguments on hybrid2's bf16 chain of _bench_setup's inputs
    (chip_smoke.two_sweep_bf16_rows' chain: the twins of B7 and B8a)."""
    xb, layers, dpb = _bench_setup(S, K, clouds)
    lp1, lp2, lp3 = layers
    R = xb.shape[0] * xb.shape[2]
    xr = SP._rows(xb).contiguous()
    p1, s1, ss1 = SF.sa_fwd_layer_bf16_plain(xr, lp1.kernel, lp1.bias)
    mul1, shift1 = _fold_affine(lp1, *_finalize(s1, ss1, R), EPS)
    p2, s2, ss2 = SF.sa_fwd_layer_bf16_plain(p1, lp2.kernel, lp2.bias, mul1,
                                             shift1)
    m2, v2 = _finalize(s2, ss2, R)
    mul2, shift2 = _fold_affine(lp2, m2, v2, EPS)
    G2, ch2 = SF.sa_fwd_gram_bf16_plain(p2, mul2, shift2)
    m3, v3 = SF._moments_from_gram(G2, ch2, lp3.kernel, lp3.bias, R)
    mul3, shift3 = _fold_affine(lp3, m3, v3, EPS)
    gi2 = lp2.scale * torch.rsqrt(v2 + EPS)
    gi3 = lp3.scale * torch.rsqrt(v3 + EPS)
    A3, u3, G2b, ch2b, q3 = SB.sa_bwd2_sweep1_bf16_plain(
        p2, mul2, shift2, lp3.kernel, lp3.bias, mul3, shift3, gi3, dpb, K)
    t3 = _layer_terms(A3, u3, lp3, m3, v3, G2b, ch2b, R, EPS)
    return (xr, p1, mul1, shift1, p2, mul2, shift2, q3,
            t3["M"].contiguous(), t3["rc"], gi2, lp2.kernel)


@pytest.mark.parametrize("S,K", [(64, 64), (32, 128)])
def test_b8b_model_within_phase2_bars_at_bench_magnitudes(S, K):
    _within_bars(sweep2_bf16_model, SB.sa_bwd2_sweep2_bf16_plain,
                 _b8b_bench_args(S, K))


@pytest.mark.parametrize("S,K", [(64, 64), (32, 128)])
def test_b6_model_within_phase2_bars_at_bench_magnitudes(S, K):
    as2 = _bench_inputs(S, K)[2]          # B3b's arguments: B6's too
    _within_bars(sweep2_full_bf16_model, SP.sa_bwd_sweep2_full_bf16_plain,
                 as2)


def _at_threshold(rng, p, mul, shift, share=0.3):
    """p (bf16) with ``share`` of its rows set where p mul + shift is zero
    (-shift / mul in bf16), then moved by -1, 0 or +1 bf16 ulp: the
    pre-activation sits within an ulp or two of the ReLU's threshold."""
    R = p.shape[0]
    rows = torch.from_numpy(rng.random(R) < share)
    at = (-shift / mul).to(BF16).expand(R, -1).clone()
    assert at.shape == p.shape
    bits = at.view(torch.int16)
    step = torch.from_numpy(rng.integers(-1, 2, size=at.shape)
                            .astype(np.int16))
    bits += step
    return torch.where(rows[:, None], at, p), rows


@pytest.mark.parametrize("form", ["B8b", "B6"])
def test_model_within_phase2_bars_at_relu_threshold(rng, form):
    """Rows whose p2 (both forms) and p1 (B8b) sit within a bf16 ulp of
    the ReLU threshold: h2 and h1 there are tiny or zero, the masks decided
    by one rounding."""
    if form == "B8b":
        args = list(_b8b_bench_args(64, 64))
        args[1], rows1 = _at_threshold(rng, args[1], args[2], args[3])
        model, twin = sweep2_bf16_model, SB.sa_bwd2_sweep2_bf16_plain
        h1 = SB._h_bf16(*args[1:4])
        assert bool((h1[rows1] > 0).any()) and bool((h1[rows1] == 0).any())
        i = 4                         # p2's place in the arguments
    else:
        args = list(_bench_inputs(64, 64)[2])
        model, twin = sweep2_full_bf16_model, \
            SP.sa_bwd_sweep2_full_bf16_plain
        i = 5
    args[i], rows2 = _at_threshold(rng, args[i], args[i + 1], args[i + 2])
    h2 = SB._h_bf16(*args[i:i + 3])
    assert bool((h2[rows2] > 0).any()) and bool((h2[rows2] == 0).any())
    _within_bars(model, twin, args)


# -- against the JAX sweeps in interpret mode ------------------------------

def _setup_c0(rng, C0):
    x = rng.normal(size=(B_TINY, C0, S_TINY, K_TINY)).astype(np.float32)
    return x, tuple(make_layers(rng, WIDTHS, C0))


@pytest.mark.parametrize("C0", [1, 4, 7])
def test_b8b_model_matches_jax_sweep(rng, monkeypatch, C0):
    """B8b's model fed the JAX side's own inputs (hybrid2's forward at
    bf16: its p1, p2, q3 and statistics) against the JAX sweep 2 of
    sa_backward_pallas in interpret mode: its packed [dy2 | m1 | m1*q2 |
    m1*x_i .. | x | h1]^T [h1 | x | ones]."""
    store = []
    monkeypatch.setattr(jsf, "pl", _Recorder(store))
    monkeypatch.setattr(jsb, "pl", _Recorder(store))
    x, layers = _setup_c0(rng, C0)
    rows = x.transpose(0, 2, 3, 1).reshape(-1, C0)
    xf = jnp.asarray(rows).astype(BF)
    _, stats, jp1, jp2 = jsf.sa_forward_pallas(xf, layers, K_TINY, EPS, BF,
                                               True)
    C1, C2, C3 = WIDTHS
    dp = jnp.asarray(rng.normal(size=(B_TINY * S_TINY, C3)).astype(
        np.float32)).astype(BF)
    jsb.sa_backward_pallas(xf, jp1, jp2, layers, stats, dp, EPS, BF, True)
    assert len(store) == 6            # layer x2, gram, pool, sweeps 1-2
    n = rows.shape[0]
    lp1, lp2, lp3 = layers
    (m1, v1), (m2, v2), (m3, v3) = stats
    mul1, shift1 = (_t(a) for a in jax_fold_affine(lp1, m1, v1, EPS))
    mul2, shift2 = (_t(a) for a in jax_fold_affine(lp2, m2, v2, EPS))
    gi2 = _t(lp2.scale * jax.lax.rsqrt(v2 + EPS))
    out1, jq3 = _t(store[4][0]), _t(store[4][1])
    t3 = jax_layer_terms(jnp.asarray(out1[:C3, :C2].numpy()),
                         jnp.asarray(out1[:C3, C2].numpy()), lp3, m3, v3,
                         jnp.asarray(out1[C3:, :C2].numpy()),
                         jnp.asarray(out1[C3:, C2].numpy()), n, EPS)
    p1b, p2b = (_t(store[i][0]).to(BF16) for i in (0, 1))
    m = sweep2_bf16_model(torch.from_numpy(rows).to(BF16), p1b, mul1,
                          shift1, p2b, mul2, shift2, jq3.to(BF16),
                          _t(t3["M"]), _t(t3["rc"]), gi2, _t(lp2.kernel))
    o = _t(store[5][0])
    h, xc, one = slice(0, C1), slice(C1, C1 + C0), C1 + C0
    want = dict(A2=o[:C2, h], u2=o[:C2, one], TM1=o[C2:C2 + C1, h],
                T1x=o[C2:C2 + C1, xc], cnt1=o[C2:C2 + C1, one],
                P1=o[C2 + C1:C2 + 2 * C1, xc],
                acc1=o[C2 + C1:C2 + 2 * C1, one])
    r = C2 + 2 * C1
    want["U1"] = torch.stack([o[r + i * C1:r + (i + 1) * C1, h]
                              for i in range(C0)], -1)
    r += C0 * C1
    want.update(Gx=o[r:r + C0, xc], cx=o[r:r + C0, one],
                G1=o[r + C0:r + C0 + C1, h], ch1=o[r + C0:r + C0 + C1, one])
    assert set(m) == set(want)
    for name, w in want.items():
        _acc(m[name], w, name)


@pytest.mark.parametrize("C0", [1, 4, 7])
def test_b6_model_matches_jax_sweep(rng, monkeypatch, C0):
    """B6's model fed the JAX side's p2, q3 and layer-3 terms against the
    JAX pair sweep at bf16 in interpret mode (facl_tpu/ops/pallas/
    sa_pair.py:333-400): its paired main [dy2 | m1 | m1*x_i .. | h1]^T h1
    and aux [dy2 | m1 | m1*q2 | x | h1]^T [x | ones] products, folded."""
    store = []
    monkeypatch.setattr(jsp, "pl", _Recorder(store))
    x, layers = _setup_c0(rng, C0)
    xf = jnp.asarray(x).astype(BF).reshape(B_TINY, C0, S_TINY * K_TINY)
    _, stats, p2p, gram2, idxp, gramx = jsp.sa_forward_pair(
        xf, layers, K_TINY, EPS, BF, True, True)
    C1, C2, C3 = WIDTHS
    dp = jnp.asarray(rng.normal(size=(B_TINY * S_TINY, C3)).astype(
        np.float32)).astype(BF)
    jsp.sa_backward_pair(xf, p2p, gram2, idxp, gramx, layers, stats, dp, EPS,
                         BF, True, False)
    assert len(store) == 4            # layer12, gram_pool, sweep 1, B6
    n = B_TINY * S_TINY * K_TINY
    lp1, lp2, lp3 = layers
    (m1, v1), (m2, v2), (m3, v3) = stats
    mul1, shift1 = jax_fold_affine(lp1, m1, v1, EPS)
    mul2, shift2 = jax_fold_affine(lp2, m2, v2, EPS)
    gi2 = lp2.scale * jax.lax.rsqrt(v2 + EPS)
    (w1, b1, _, _), (w2, _, _, _), _ = (tuple(_t(t) for t in lp)
                                        for lp in layers)
    x3 = torch.from_numpy(x).reshape(B_TINY, C0, S_TINY * K_TINY).to(BF16)
    r = store[2]
    jA3, ju3, jq3 = _fold2(r[0], C3, C2), _lanes(r[1], C3), _unpair(r[2], C2)
    t3 = jax_layer_terms(jnp.asarray(jA3.numpy()), jnp.asarray(ju3.numpy()),
                         lp3, m3, v3, gram2[0], gram2[1], n, EPS)
    m = sweep2_full_bf16_model(
        x3, w1, b1, _t(mul1), _t(shift1), _unpair(store[0][0], C2).to(BF16),
        _t(mul2), _t(shift2), jq3.to(BF16), _t(t3["M"]), _t(t3["rc"]),
        _t(gi2), w2)
    om, oa = _t(store[3][0]), _t(store[3][1])

    def fm(i, a, b_):       # the i-th (2a, 2C1) block of main, folded
        return om[i:i + 2 * a, :2 * b_][:a, :b_] + \
            om[i:i + 2 * a, :2 * b_][a:, b_:]

    def fa(i, a):           # aux rows i .. i + 2a: x block folded, ones
        blk = oa[i:i + 2 * a]
        return (blk[:a, :C0] + blk[a:, C0:2 * C0],
                blk[:a, 2 * C0] + blk[a:, 2 * C0])
    want = dict(A2=fm(0, C2, C1), TM1=fm(2 * C2, C1, C1),
                U1=torch.stack([fm(2 * C2 + 2 * C1 * (1 + i), C1, C1)
                                for i in range(C0)], -1),
                G1=fm(2 * C2 + 2 * C1 * (1 + C0), C1, C1))
    want["u2"] = fa(0, C2)[1]
    want["T1x"], want["cnt1"] = fa(2 * C2, C1)
    want["P1"], want["acc1"] = fa(2 * C2 + 2 * C1, C1)
    want["Gx"], want["cx"] = fa(2 * C2 + 4 * C1, C0)
    want["ch1"] = fa(2 * C2 + 4 * C1 + 2 * C0, C1)[1]
    assert set(m) == set(want)
    for name, w in want.items():
        _acc(m[name], w, name)
