"""The order of sums of the f32 B8b (sa_bwd2_sweep2, h1 from the stored
p1) and B6 (sa_bwd_sweep2_full, h1 from x) on the TF32 tensor cores,
modelled in torch on the CPU (``sweep2_tf32_model``,
``sweep2_full_tf32_model``, with the twins' signatures), held against
their f32 twins (ops/sa_bwd.py::_sweep2_plain) and against the JAX sweeps
they port, run in interpret mode.

On the card (facl_tpu_torch/ops/csrc/sa_2sweep.cu, bwd2_sweep2_tf32_kernel)
every product runs in 3xTF32 on wgmma: each f32 operand split as
tf32_mma.cuh's split splits it, hi = tf32(a) and lo = tf32(a - hi), each
rounded to nearest (tests/test_torch_tf32x3.py::tf32), a product summed
as lo hi' + hi lo' + hi hi'. The row products h2 M3 and q2 = dy2
(gi2 W2^T) (gi2 folded into W2, one f32 product a weight) chain their 64
channels in the tensor cores (``_chain``: one step); the contraction over
rows, [dy2 | h1 | m1 | m1 x_i]^T h1 (m1 x_i split as x_i, anded with the
mask) and [dy2 | m1 | mq | h1 | x]^T [x | 1], sums each k8 step of 8
rows on its own (the exact piece products summed in float64 and rounded
to f32 once: the tensor cores' truncating adds inside a step are not
modelled), adds it to the f32 accumulator round-to-nearest, and adds the
accumulator to float64 every S2T_FLUSH = 128 steps of 64 rows (8,192
rows). m1 and the ones column are exact in TF32 (lo 0: their products
are two passes). The models sum in that order (one block walking every
row: the longest chains); B6's h1 by its k-order chain (h1_pair), so the
layer-1 masks, and cnt1, are the forward's. So the bars the card is held
to can be checked against that order here:

  * at bench.py's magnitudes (the model's SA weights at full width, randn
    clouds grouped at S = K = 64 and at the fine variant's S = 32, K =
    128, through hybrid2's and pair's f32 twins) and on rows whose p1 or
    p2 sits within an f32 ulp of the ReLU threshold, each model sits
    within chip_smoke.py phase 2's f32 bar (1e-4 of the twin's max-abs),
    cnt1 exact;
  * on the tiny shapes of tests/test_torch_sa_hybrid.py and
    test_torch_sa_pair.py (widths 8-8-16) at C0 = 1, 4 and 7 it sits
    within 1e-5 of the max-abs of the JAX sweeps' outputs (facl_tpu/ops/
    pallas/sa_bwd.py pallas_call :298, sa_pair.py :863, at f32), as
    tests/test_torch_bf16_sa.py holds the sweeps.
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
from tests.test_torch_bf16_mma_order import _bench_setup
from tests.test_torch_bf16_sa import B as B_TINY, EPS, K as K_TINY, \
    S as S_TINY, WIDTHS, _acc, _fold2, _lanes, _Recorder, _t, _unpair
from tests.test_torch_tf32x3 import tf32

#: Rows between the card's float64 adds (S2T_FLUSH steps of 64 rows).
FLUSH_ROWS = 128 * 64
#: chip_smoke.py phase 2's f32 bar for an accumulator (acc_err): a share
#: of the twin's max-abs.
F32_BAR = 1e-4


# -- the models -------------------------------------------------------------

def _split(a):
    """tf32_mma.cuh's split: hi and lo = a - hi, each rounded to TF32."""
    hi = tf32(a)
    return hi, tf32(a - hi)


def _chain(a, b):
    """a @ b as the row chain's 3xTF32 products run: the piece products
    of every k summed exactly, rounded to f32 once."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return (al.double() @ bh.double() + ah.double() @ bl.double()
            + ah.double() @ bh.double()).float()


def _rows_sum(a, b, chunk=FLUSH_ROWS):
    """a^T b over rows as the card sums it: each k8 step of 8 rows, its
    three piece products lo hi' + hi lo' + hi hi' summed exactly (float64)
    and rounded to f32, added to an f32 accumulator in row order, the
    accumulator added to float64 every ``chunk`` rows."""
    R = a.shape[0]
    (ah, al), (bh, bl) = _split(a), _split(b)
    out = torch.zeros(a.shape[1], b.shape[1], dtype=torch.float64)
    for r0 in range(0, R, chunk):
        s = slice(r0, min(r0 + chunk, R))

        def steps(u, v):
            u, v = u[s].double(), v[s].double()
            return u.view(-1, 8, u.shape[1]).transpose(1, 2) @ \
                v.view(-1, 8, v.shape[1])
        st = (steps(al, bh) + steps(ah, bl) + steps(ah, bh)).float()
        acc = torch.zeros(a.shape[1], b.shape[1])
        for k8 in st:
            acc = acc + k8
        out += acc.double()
    return out.float()


def _sweep2_model(x, h1, p2, mul2, shift2, q3, M3, rc3, gi2, w2):
    """The accumulators of ops/sa_bwd.py::_sweep2_plain in the card's
    order from x (R, C0) and h1."""
    h2 = SB._h_from_p(p2, mul2, shift2)
    dy2 = torch.where(h2 > 0, q3 - _chain(h2, M3) - rc3, 0.0)
    q2 = _chain(dy2, gi2[:, None] * w2.T)
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


def _h1_chain(x3, w1, b1, mul1, shift1):
    """h1 as the kernel's h1_pair makes it (the forward's chain): x W1 summed
    channel by channel in f32 (each product and sum rounded), then
    relu((a + b1) mul1 + shift1)."""
    xr = SP._rows(x3)
    a = xr[:, :1] * w1[0]
    for k in range(1, xr.shape[1]):
        a = a + xr[:, k:k + 1] * w1[k]
    return torch.relu((a + b1) * mul1 + shift1)


def sweep2_tf32_model(x, p1, mul1, shift1, p2, mul2, shift2, q3, M3, rc3,
                      gi2, w2):
    """B8b in the card's order of sums, with its twin's signature
    (ops/sa_bwd.py::sa_bwd2_sweep2_plain)."""
    return _sweep2_model(x, SB._h_from_p(p1, mul1, shift1), p2, mul2,
                         shift2, q3, M3, rc3, gi2, w2)


def sweep2_full_tf32_model(x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3,
                           M3, rc3, gi2, w2):
    """B6 in the card's order of sums, with its twin's signature
    (ops/sa_pair.py::sa_bwd_sweep2_full_plain): h1 by the kernel's k-order
    chain."""
    return _sweep2_model(SP._rows(x3), _h1_chain(x3, w1, b1, mul1, shift1),
                         p2, mul2, shift2, q3, M3, rc3, gi2, w2)


# -- against the twins at phase 2's f32 bar ---------------------------------

def _within_bar(model, twin, args):
    """The model against the twin: cnt1 exact, every accumulator within
    F32_BAR of the twin's max-abs."""
    m, t = model(*args), twin(*args)
    assert set(m) == set(t)
    assert torch.equal(m["cnt1"], t["cnt1"])
    for n in t:
        scale = max(float(t[n].abs().max()), 1e-30)
        err = float((m[n] - t[n]).abs().max())
        assert err <= F32_BAR * scale, (n, err, scale)


def _b8b_bench_args(S, K, clouds=4):
    """B8b's arguments on hybrid2's f32 chain of _bench_setup's inputs
    (chip_smoke.two_sweep_rows' chain: the twins of B7 and B8a)."""
    xb, layers, dpb = _bench_setup(S, K, clouds)
    lp1, lp2, lp3 = layers
    R = xb.shape[0] * xb.shape[2]
    xr = SP._rows(xb.float()).contiguous()
    p1, s1, ss1 = SF.sa_fwd_layer_plain(xr, lp1.kernel, lp1.bias)
    mul1, shift1 = _fold_affine(lp1, *_finalize(s1, ss1, R), EPS)
    p2, s2, ss2 = SF.sa_fwd_layer_plain(p1, lp2.kernel, lp2.bias, mul1,
                                        shift1)
    m2, v2 = _finalize(s2, ss2, R)
    mul2, shift2 = _fold_affine(lp2, m2, v2, EPS)
    G2, ch2 = SF.sa_fwd_gram_plain(p2, mul2, shift2)
    m3, v3 = SF._moments_from_gram(G2, ch2, lp3.kernel, lp3.bias, R)
    mul3, shift3 = _fold_affine(lp3, m3, v3, EPS)
    gi2 = lp2.scale * torch.rsqrt(v2 + EPS)
    gi3 = lp3.scale * torch.rsqrt(v3 + EPS)
    A3, u3, G2b, ch2b, q3 = SB.sa_bwd2_sweep1_plain(
        p2, mul2, shift2, lp3.kernel, lp3.bias, mul3, shift3, gi3,
        dpb.float(), K)
    t3 = _layer_terms(A3, u3, lp3, m3, v3, G2b, ch2b, R, EPS)
    return (xr, p1, mul1, shift1, p2, mul2, shift2, q3,
            t3["M"].contiguous(), t3["rc"], gi2, lp2.kernel)


def _b6_bench_args(S, K, clouds=4):
    """B6's arguments on pair's f32 chain of _bench_setup's inputs
    (chip_smoke.phase_kernels' chain: the twins of B2 and B3a)."""
    xb, layers, dpb = _bench_setup(S, K, clouds)
    lp1, lp2, lp3 = layers
    x3 = xb.float()
    R = x3.shape[0] * x3.shape[2]
    m1, v1 = SP._moments_from_gram(torch.einsum("bcn,bdn->cd", x3, x3),
                                   x3.sum((0, 2)), lp1.kernel, lp1.bias, R)
    mul1, shift1 = _fold_affine(lp1, m1, v1, EPS)
    p2, s2, ss2 = SP.sa_fwd_layer12_plain(x3, lp1.kernel, lp1.bias, mul1,
                                          shift1, lp2.kernel, lp2.bias)
    m2, v2 = _finalize(s2, ss2, R)
    mul2, shift2 = _fold_affine(lp2, m2, v2, EPS)
    G2, ch2, mx, mn, imx, imn = SP.sa_fwd_gram_pool_plain(
        p2, mul2, shift2, lp3.kernel, lp3.bias, K)
    m3, v3 = SP._moments_from_gram(G2, ch2, lp3.kernel, lp3.bias, R)
    mul3, shift3 = _fold_affine(lp3, m3, v3, EPS)
    sel = mul3 >= 0
    zstar = torch.where(sel, mx, mn) * mul3 + shift3
    idx = torch.where(zstar > 0, torch.where(sel, imx, imn),
                      torch.full_like(imx, K))
    gi2 = lp2.scale * torch.rsqrt(v2 + EPS)
    gi3 = lp3.scale * torch.rsqrt(v3 + EPS)
    A3, u3, q3 = SP.sa_bwd_sweep1_plain(p2, mul2, shift2, dpb.float(), idx,
                                        gi3, lp3.kernel, K)
    t3 = _layer_terms(A3, u3, lp3, m3, v3, G2, ch2, R, EPS)
    return (x3, lp1.kernel, lp1.bias, mul1, shift1, p2, mul2, shift2, q3,
            t3["M"].contiguous(), t3["rc"], gi2, lp2.kernel)


@pytest.mark.parametrize("S,K", [(64, 64), (32, 128)])
def test_b8b_model_within_phase2_bar_at_bench_magnitudes(S, K):
    _within_bar(sweep2_tf32_model, SB.sa_bwd2_sweep2_plain,
                _b8b_bench_args(S, K))


@pytest.mark.parametrize("S,K", [(64, 64), (32, 128)])
def test_b6_model_within_phase2_bar_at_bench_magnitudes(S, K):
    _within_bar(sweep2_full_tf32_model, SP.sa_bwd_sweep2_full_plain,
                _b6_bench_args(S, K))


def _at_threshold(rng, p, mul, shift, share=0.3):
    """p with ``share`` of its rows set where p mul + shift is zero
    (-shift / mul in f32), then moved by -1, 0 or +1 f32 ulp: the
    pre-activation sits within an ulp or two of the ReLU's threshold."""
    R = p.shape[0]
    rows = torch.from_numpy(rng.random(R) < share)
    at = (-shift / mul).expand(R, -1).clone()
    assert at.shape == p.shape
    bits = at.view(torch.int32)
    bits += torch.from_numpy(rng.integers(-1, 2, size=at.shape)
                             .astype(np.int32))
    return torch.where(rows[:, None], at, p), rows


@pytest.mark.parametrize("form", ["B8b", "B6"])
def test_model_within_phase2_bar_at_relu_threshold(rng, form):
    """Rows whose p2 (both forms) and p1 (B8b) sit within an f32 ulp of
    the ReLU threshold: h2 and h1 there are tiny or zero, the masks decided
    by one rounding."""
    if form == "B8b":
        args = list(_b8b_bench_args(64, 64))
        args[1], rows1 = _at_threshold(rng, args[1], args[2], args[3])
        model, twin = sweep2_tf32_model, SB.sa_bwd2_sweep2_plain
        h1 = SB._h_from_p(*args[1:4])
        assert bool((h1[rows1] > 0).any()) and bool((h1[rows1] == 0).any())
        i = 4                         # p2's place in the arguments
    else:
        args = list(_b6_bench_args(64, 64))
        model, twin = sweep2_full_tf32_model, SP.sa_bwd_sweep2_full_plain
        i = 5
    args[i], rows2 = _at_threshold(rng, args[i], args[i + 1], args[i + 2])
    h2 = SB._h_from_p(*args[i:i + 3])
    assert bool((h2[rows2] > 0).any()) and bool((h2[rows2] == 0).any())
    _within_bar(model, twin, args)


# -- against the JAX sweeps in interpret mode ------------------------------

def _setup_c0(rng, C0):
    x = rng.normal(size=(B_TINY, C0, S_TINY, K_TINY)).astype(np.float32)
    return x, tuple(make_layers(rng, WIDTHS, C0))


@pytest.mark.parametrize("C0", [1, 4, 7])
def test_b8b_model_matches_jax_sweep(rng, monkeypatch, C0):
    """B8b's model fed the JAX side's own inputs (hybrid2's f32 forward:
    its p1, p2, q3 and statistics) against the JAX sweep 2 of
    sa_backward_pallas in interpret mode: its packed [dy2 | m1 | m1*q2 |
    m1*x_i .. | x | h1]^T [h1 | x | ones]."""
    store = []
    monkeypatch.setattr(jsf, "pl", _Recorder(store))
    monkeypatch.setattr(jsb, "pl", _Recorder(store))
    x, layers = _setup_c0(rng, C0)
    rows = x.transpose(0, 2, 3, 1).reshape(-1, C0)
    xf = jnp.asarray(rows)
    f32 = jnp.float32
    _, stats, jp1, jp2 = jsf.sa_forward_pallas(xf, layers, K_TINY, EPS, f32,
                                               True)
    C1, C2, C3 = WIDTHS
    dp = jnp.asarray(rng.normal(size=(B_TINY * S_TINY, C3)).astype(
        np.float32))
    jsb.sa_backward_pallas(xf, jp1, jp2, layers, stats, dp, EPS, f32, True)
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
    p1, p2 = (_t(store[i][0]) for i in (0, 1))
    m = sweep2_tf32_model(torch.from_numpy(rows), p1, mul1, shift1, p2,
                          mul2, shift2, jq3, _t(t3["M"]), _t(t3["rc"]), gi2,
                          _t(lp2.kernel))
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
    assert torch.equal(m["cnt1"], want["cnt1"])
    for name, w in want.items():
        _acc(m[name], w, name)


@pytest.mark.parametrize("C0", [1, 4, 7])
def test_b6_model_matches_jax_sweep(rng, monkeypatch, C0):
    """B6's model fed the JAX side's p2, q3 and layer-3 terms against the
    JAX pair sweep at f32 in interpret mode (facl_tpu/ops/pallas/
    sa_pair.py:333-400): its paired main [dy2 | m1 | m1*x_i .. | h1]^T h1
    and aux [dy2 | m1 | m1*q2 | x | h1]^T [x | ones] products, folded."""
    store = []
    monkeypatch.setattr(jsp, "pl", _Recorder(store))
    x, layers = _setup_c0(rng, C0)
    xf = jnp.asarray(x).reshape(B_TINY, C0, S_TINY * K_TINY)
    f32 = jnp.float32
    _, stats, p2p, gram2, idxp, gramx = jsp.sa_forward_pair(
        xf, layers, K_TINY, EPS, f32, True, True)
    C1, C2, C3 = WIDTHS
    dp = jnp.asarray(rng.normal(size=(B_TINY * S_TINY, C3)).astype(
        np.float32))
    jsp.sa_backward_pair(xf, p2p, gram2, idxp, gramx, layers, stats, dp, EPS,
                         f32, True, False)
    assert len(store) == 4            # layer12, gram_pool, sweep 1, B6
    n = B_TINY * S_TINY * K_TINY
    lp1, lp2, lp3 = layers
    (m1, v1), (m2, v2), (m3, v3) = stats
    mul1, shift1 = jax_fold_affine(lp1, m1, v1, EPS)
    mul2, shift2 = jax_fold_affine(lp2, m2, v2, EPS)
    gi2 = lp2.scale * jax.lax.rsqrt(v2 + EPS)
    (w1, b1, _, _), (w2, _, _, _), _ = (tuple(_t(t) for t in lp)
                                        for lp in layers)
    x3 = torch.from_numpy(x).reshape(B_TINY, C0, S_TINY * K_TINY)
    r = store[2]
    jA3, ju3, jq3 = _fold2(r[0], C3, C2), _lanes(r[1], C3), _unpair(r[2], C2)
    t3 = jax_layer_terms(jnp.asarray(jA3.numpy()), jnp.asarray(ju3.numpy()),
                         lp3, m3, v3, gram2[0], gram2[1], n, EPS)
    m = sweep2_full_tf32_model(
        x3, w1, b1, _t(mul1), _t(shift1), _unpair(store[0][0], C2),
        _t(mul2), _t(shift2), jq3, _t(t3["M"]), _t(t3["rc"]), _t(gi2), w2)
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
    assert torch.equal(m["cnt1"], want["cnt1"])
    for name, w in want.items():
        _acc(m[name], w, name)
