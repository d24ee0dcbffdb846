"""The order of sums of B7a, hybrid2's layer sweep (sa_fwd_layer and
sa_fwd_layer_bf16, both call shapes: x -> p1 and p1 -> p2), modelled in
torch on the CPU with the twins' signatures, held against the f32 and
bf16 twins (ops/sa_fwd.py::sa_fwd_layer_plain, sa_fwd_layer_bf16_plain)
and against the JAX layer sweep they port
(facl_tpu/ops/pallas/sa_fwd.py::_make_layer_sweep, pallas_call :189), run
in interpret mode.

On the card (facl_tpu_torch/ops/csrc/sa_layer.cu) each warp walks its own
row steps:

  * x -> p1 (layer_x_kernel): p = the k-order chain of FMAs from +0 over
    x's channels (fmaf(x_k, w_k, acc): one rounding a step), then + b; at
    bf16 W and b rounded to bf16 and the chain rounded to bf16 before b
    is added (each product of two bf16 values is exact in f32, so the
    chain is f32 multiply-adds: the model's form). 32-row steps.
  * p1 -> p2 at bf16 (layer_p_bf16_kernel): h1 = relu(bf16(p1 mul1 +
    shift1)); h1 bf16(W2) one k16 step at a time on the tensor cores
    (each step exact, rounded once, added to the f32 accumulator in k
    order); p2 = bf16(acc) + bf16(b2) in f32. 32-row steps.
  * p1 -> p2 at f32 (layer_p_f32_kernel): h1 = relu(p1 mul1 + shift1),
    then the k-order FMA chain over the 64 columns from +0, + b2. 16-row
    steps.

Every form takes the sums of p and p^2 from the unrounded p (the bf16
twins' contract, the JAX sweep's on the CPU): in f32 within a step, each
lane over its rows in order (p, p^2 first as a product, then a fused
multiply-add), then the lanes holding the same columns added pairwise
(halve: butterflies over the lane's row bits); the steps in float64.
fma32 is fmaf exactly (float64 product and TwoSum, an f32 midpoint the
float64 sum lands on settled by the TwoSum error), held against exact
rational rounding (fma32: tests/test_torch_b7a_cuda.py's, which holds
the card's p1 and f32 p2 to the same chain).

The bars: at bench.py's magnitudes (the model's SA weights at full
width, randn clouds grouped at S = K = 64 and at S = 32, K = 128, through
hybrid2's twins) and on rows whose layer-1 pre-activation (p1 mul1 +
shift1) or output (p) sits within an ulp of 0, each model sits within
chip_smoke.py phase 2's bars of its twin (f32: rows at rtol 1e-5 / atol
1e-5 x scale, sums within 1e-4 of their max-abs; bf16: one bf16 ulp
outside at most 1e-3 of the entries, sums within ACC2_BAR); on
tests/test_torch_bf16_sa.py's tiny shapes it sits within that file's
tolerances of the JAX sweep (f32 rows at phase 2's bar; bf16 rows one
ulp apart on at most 1% of the entries; sums within 1e-5 of their
max-abs, the JAX sums taken before the bf16 rounding). And chip_smoke.py
--parent's comparison of B7a with the former kernel (layer_vs_parent).
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu.ops.pallas.sa_bwd import _fold_affine as jax_fold_affine
from facl_tpu_torch.ops import sa_fwd as SF
from facl_tpu_torch.ops.sa_bwd import _fold_affine, _h_bf16, _h_from_p, \
    _rb
from tests.test_torch_b7a_cuda import fma32, fma_chain
from tests.test_torch_bf16_mma_order import _k16, cs
from tests.test_torch_bf16_sa import BF, C0, EPS, K as K_TINY, _acc, \
    _bf16_rows, _rec_two_sweep, _setup, _t

BF16 = torch.bfloat16


# -- fmaf ---------------------------------------------------------------------

def _round32(q: Fraction) -> np.float32:
    """The f32 nearest the rational q, ties to even."""
    r = np.float32(float(q))
    best = None
    for v in (np.nextafter(r, np.float32(-np.inf)), r,
              np.nextafter(r, np.float32(np.inf))):
        d = abs(Fraction(float(v)) - q)
        if best is None or d < best[0] or (
                d == best[0] and int(v.view(np.int32)) % 2 == 0):
            best = (d, v)
    return best[1]


def test_fma32_is_one_rounding(rng):
    """fma32 against exact rational arithmetic, on random operands and on
    sums that land on (or next to) an f32 midpoint, zeros and cancels."""
    n = 3000
    a = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    c = rng.normal(size=n).astype(np.float32)
    k = n // 3                  # c = -a b rounded: the sum cancels to e
    c[:k] = -(a[:k].astype(np.float64) * b[:k]).astype(np.float32)
    # products that sit half an ulp (of c) off c's grid: midpoints of f32
    m = slice(k, 2 * k)
    c[m] = np.float32(1.0) + np.float32(2.0 ** -10) * rng.integers(
        0, 1024, size=k).astype(np.float32)
    a[m] = np.float32(2.0 ** -24) * (1 + 2 * rng.integers(
        0, 8, size=k)).astype(np.float32)
    b[m] = np.where(rng.random(size=k) < 0.5, 1, -1).astype(np.float32) * \
        (np.float32(1.0) + np.float32(2.0 ** -20) * rng.integers(
            -2, 3, size=k).astype(np.float32))
    a[-5:], b[-5:], c[-5:] = 0.0, -1.0, np.float32(-0.0)
    # a b = 2^-24 - 2^-60 off c = 1 + 2^-23 (odd): the float64 sum rounds
    # onto the f32 midpoint, whose even neighbour is the wrong answer
    for i, (sb, sc, cc) in enumerate([(1, 1, 1 + 2.0 ** -23),
                                      (-1, -1, 1 + 2.0 ** -23),
                                      (1, 1, 1.0), (-1, 1, 1 + 2.0 ** -22),
                                      (1, -1, 1 + 3 * 2.0 ** -23),
                                      (-1, -1, 1 + 3 * 2.0 ** -23)]):
        j = 2 * k + i
        a[j] = np.float32(2.0 ** -24 * (1 + 2.0 ** -18))
        b[j] = np.float32(sb * (1 - 2.0 ** -18))
        c[j] = np.float32(sc * sb * cc)
    got = fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for i in range(n):
        q = Fraction(float(a[i])) * Fraction(float(b[i])) + \
            Fraction(float(c[i]))
        want = _round32(q)
        if q == 0:                 # zero: the sign rules of IEEE addition
            want = np.float32(-0.0) if np.signbit(a[i] * b[i]) and \
                np.signbit(c[i]) else np.float32(0.0)
        assert got[i].view(np.int32) == want.view(np.int32), (i, a[i], b[i],
                                                               c[i])


# -- the models ---------------------------------------------------------------

def _bf16_chain(h, w):
    """The same chain where every product is exact in f32 (bf16 operands):
    a product, then a sum, each rounded (the kernel's x -> p1 at bf16)."""
    acc = torch.zeros(h.shape[0], w.shape[1])
    for k in range(h.shape[1]):
        acc = acc + h[:, k:k + 1] * w[k]
    return acc


def _lane_sums(p, step, nl, masks):
    """The kernel's sums of p and p^2 by column: within each ``step``-row
    step, lane row group l (of nl) sums rows l, l + nl, ... in order in
    f32 (p^2: the first a product, then fmaf), the groups added pairwise
    over the row bits ``masks`` (halve); the steps summed in float64."""
    R, C = p.shape
    v = p.reshape(R // step, step // nl, nl, C)
    s, ss = v[:, 0], v[:, 0] * v[:, 0]
    for q in range(1, step // nl):
        s = s + v[:, q]
        ss = fma32(v[:, q], v[:, q], ss)
    for m in masks:
        idx = torch.arange(nl) ^ m
        s, ss = s + s[:, idx], ss + ss[:, idx]
    return s[:, 0].double().sum(0).float(), ss[:, 0].double().sum(0).float()


#: (rows a step, lane row groups, their bits as halve visits them) by form.
SUMS = {("x", "bf16"): (32, 4, (2, 1)), ("x", "f32"): (32, 2, (1,)),
        ("p", "bf16"): (32, 8, (4, 2, 1)), ("p", "f32"): (16, 4, (2, 1))}


def b7a_f32_model(inp, w, b, mul=None, shift=None):
    """B7a at f32 in the kernel's order (sa_fwd_layer_plain's signature)."""
    h = inp if mul is None else _h_from_p(inp, mul, shift)
    p = fma_chain(h, w) + b
    return (p, *_lane_sums(p, *SUMS["x" if mul is None else "p", "f32"]))


def b7a_bf16_model(inp, w, b, mul=None, shift=None):
    """B7a at bf16 in the kernel's order (sa_fwd_layer_bf16_plain's)."""
    if mul is None:
        acc = _bf16_chain(inp.float(), _rb(w))
    else:
        acc = _k16(_h_bf16(inp, mul, shift), _rb(w))
    p = _rb(acc) + _rb(b)
    return (p.to(BF16),
            *_lane_sums(p, *SUMS["x" if mul is None else "p", "bf16"]))


MODELS = {"f32": (b7a_f32_model, SF.sa_fwd_layer_plain),
          "bf16": (b7a_bf16_model, SF.sa_fwd_layer_bf16_plain)}


def _within_bars(dt, args, name):
    """The model against its twin at phase 2's bars; returns the bf16
    entries beyond one ulp (0 at f32)."""
    (p, s, ss), (tp, ts, tss) = (f(*args) for f in MODELS[dt])
    if dt == "f32":
        cs.row_err(p, tp, f"{name} p")
        cs.acc_err(s, ts, f"{name} sum p")
        cs.acc_err(ss, tss, f"{name} sum p^2")
        return 0
    cs.acc_rel(s, ts, f"{name} sum p", cs.ACC2_BAR)
    cs.acc_rel(ss, tss, f"{name} sum p^2", cs.ACC2_BAR)
    return cs.bf16_flips(p, tp, f"{name} p")[0]


# -- inputs -------------------------------------------------------------------

def _bench_args(S, K, dt, clouds=4):
    """B7a's two calls on hybrid2's forward (the twins) of bench.py's
    magnitudes: the model's SA weights at full width, randn clouds grouped
    (B1's twin) and centred, x in ``dt``."""
    from facl_tpu_torch.ops import select as SEL
    from facl_tpu_torch.train import Trainer
    model = Trainer(cs._cfg(2), 100, device="cpu").init_state(cs.SEED).model
    lp1, lp2, _ = [SF.SALayerParams(*(t.detach() for t in lp))
                   for lp in model.sa_stage.layers()]
    g = torch.Generator().manual_seed(cs.SEED)
    flat = torch.randn(clouds, 512, 4, generator=g)
    with torch.no_grad():
        grouped, _ = SEL.select_gather(flat, S, K, 0.06)
    grouped[:, :3] -= flat[:, :S, :3].transpose(1, 2)[..., None]
    R = clouds * S * K
    x = grouped.reshape(clouds, 4, S * K).transpose(1, 2).reshape(R, 4)
    x = x.to(BF16) if dt == "bf16" else x.contiguous()
    a1 = (x, lp1.kernel, lp1.bias)
    p1, s1, ss1 = MODELS[dt][1](*a1)
    mul1, shift1 = _fold_affine(lp1, *SF._finalize(s1, ss1, R), EPS)
    return a1, (p1, lp2.kernel, lp2.bias, mul1, shift1)


def _zero_args(rng, dt, R=64 * 48):
    """Both calls at an ulp from 0: a third of p1's entries at a layer-1
    pre-activation within an ulp of 0 (p1 at -shift1 / mul1, nudged by an
    ulp either way or not), and for a quarter of the channels b set so
    that p is 0 at one row (another row a channel) in the twin's sums."""
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.normal(size=s)).astype(np.float32))
    bf = dt == "bf16"
    twin = MODELS[dt][1]
    mul1, shift1 = 1.0 + f(64, sc=0.3), f(64, sc=0.2)
    zero = (-shift1 / mul1).expand(R, 64)
    at = torch.from_numpy(rng.random(size=(R, 64)) < 1 / 3)
    step = torch.from_numpy(rng.integers(-1, 2, size=(R, 64)))
    p1 = f(R, 64)
    if bf:
        near = (zero.to(BF16).contiguous().view(torch.int16) +
                step.to(torch.int16)).view(BF16)
        p1 = torch.where(at, near, p1.to(BF16))
        pre = p1.float() * mul1 + shift1
        ulp = 2.0 ** -7
    else:
        p1 = torch.where(at, torch.nextafter(zero, zero + step), p1)
        pre = p1 * mul1 + shift1
        ulp = 2.0 ** -20
    assert int((pre.abs() <= ulp * float(shift1.abs().max())).sum()) > \
        0.2 * pre.numel()
    x = f(R, 4).to(BF16) if bf else f(R, 4)
    ch = torch.arange(64)
    rows = (ch * 37) % R
    calls = []
    for inp, w, aff in ((x, f(4, 64, sc=0.5), ()),
                        (p1, f(64, 64, sc=0.125), (mul1, shift1))):
        acc = twin(inp, w, torch.zeros(64), *aff)[0].float()
        sel = torch.from_numpy(rng.random(size=64) < 0.25)
        b = torch.where(sel, -acc[rows, ch], f(64, sc=0.1))
        p = twin(inp, w, b, *aff)[0].float()
        assert int((p[rows, ch][sel] == 0).sum()) >= 4
        calls.append((inp, w, b, *aff))
    return calls


# -- the models against the twins at phase 2's bars ---------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S,K", [(64, 64), (32, 128)])
def test_b7a_model_within_phase2_bars_at_bench_magnitudes(S, K, dt):
    a1, a2 = _bench_args(S, K, dt)
    _within_bars(dt, a1, "B7a x->p1")
    _within_bars(dt, a2, "B7a p1->p2")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_b7a_model_within_phase2_bars_at_zero(rng, dt):
    a1, a2 = _zero_args(rng, dt)
    _within_bars(dt, a1, "B7a x->p1 at 0")
    _within_bars(dt, a2, "B7a p1->p2 at 0")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_b7a_models_keep_the_twins_relu_decisions(rng, dt):
    """h1 at the ReLU's edge: the models' h1 is the twin's bit for bit
    (the same elementwise chain, the mask on the rounded value at bf16)."""
    _, (p1, _, _, mul1, shift1) = _zero_args(rng, dt)
    if dt == "bf16":
        h = _h_bf16(p1, mul1, shift1)
        want = torch.relu(_rb(p1.float() * mul1 + shift1))
    else:
        h = _h_from_p(p1, mul1, shift1)
        want = torch.clamp_min(p1 * mul1 + shift1, 0.0)
    assert torch.equal(h, want)


@pytest.mark.parametrize("cin", range(1, 8))
def test_b7a_x_model_is_the_k_order_chain(rng, cin):
    """x -> p1 at bf16: the model's chain (a product, then a sum) is the
    kernel's fmaf chain from +0 bit for bit, zeros' signs included, for
    every cin the kernel takes; at f32 the model is that chain."""
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x, w = _rb(f(640, cin)), _rb(f(cin, 64))
    x[::7] = 0.0
    x[1::7] = -0.0
    w[:, ::5] = -0.0
    a, b = _bf16_chain(x, w), fma_chain(x, w)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# -- the models against the JAX layer sweep (interpret mode) -----------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("negative_scale", [False, True])
def test_b7a_model_matches_jax_layer_sweep(rng, monkeypatch, dt,
                                           negative_scale):
    """Each model fed the JAX side's own inputs (hybrid2's forward at the
    dtype: x rows, its p1 and layer-1 statistics) against the two layer
    sweeps of sa_forward_pallas in interpret mode: p1 and p2, and their
    sums (at bf16 taken before the rounding, as the JAX sweep's are on the
    CPU)."""
    x, layers = _setup(rng, negative_scale)
    jdt = BF if dt == "bf16" else jnp.float32
    rows = x.transpose(0, 2, 3, 1).reshape(-1, C0)
    store = []
    jsf, _ = _rec_two_sweep(monkeypatch, store)
    _, stats, _, _ = jsf.sa_forward_pallas(jnp.asarray(rows).astype(jdt),
                                           layers, K_TINY, EPS, jdt, True)
    lp1, lp2, _ = layers
    (m1, v1), _, _ = stats
    mul1, shift1 = (_t(a) for a in jax_fold_affine(lp1, m1, v1, EPS))
    xr = torch.from_numpy(rows)
    jp1 = _t(store[0][0])
    if dt == "bf16":
        xr, jp1 = xr.to(BF16), jp1.to(BF16)
    calls = ((xr, _t(lp1.kernel), _t(lp1.bias)),
             (jp1, _t(lp2.kernel), _t(lp2.bias), mul1, shift1))
    for i, args in enumerate(calls):
        p, s, ss = MODELS[dt][0](*args)
        jp = _t(store[i][0])
        if dt == "bf16":
            _bf16_rows(p, jp, f"p{i + 1}")
        else:
            cs.row_err(p, jp, f"p{i + 1}")
        _acc(s, _t(store[i][1])[0], f"sum p{i + 1}")
        _acc(ss, _t(store[i][2])[0], f"sum p{i + 1}^2")


# -- chip_smoke.py --parent: B7a against the former kernel -------------------

def _outs(rng, dt, R=256):
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    p = f(R, 64)
    p = p.to(BF16) if dt == "bf16" else p
    mine = [p, 100.0 * f(64), 1e4 + f(64).abs()]
    return mine, [t.clone() for t in mine]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("affine", [False, True])
def test_parent_layer_comparison_passes(rng, dt, affine):
    """Sums a few ulps off the parent's pass; at bf16 p1 -> p2 (the tensor
    cores' order) a few p2 entries one bf16 ulp off pass too."""
    mine, theirs = _outs(rng, dt)
    mine[1][3] = torch.nextafter(mine[1][3], torch.tensor(1e30))
    mine[2] *= 1.0 + 2.0 ** -21
    if dt == "bf16" and affine:
        bits = mine[0].view(torch.int16)
        bits[5, :3] += 1
    note = cs.layer_vs_parent("sa_fwd_layer", mine, theirs, affine)
    assert "sums within phase 2's bar" in note


@pytest.mark.parametrize("dt,affine", [("f32", False), ("f32", True),
                                       ("bf16", False)])
def test_parent_layer_comparison_wants_bit_equal_p(rng, dt, affine):
    """p1 at either dtype and the f32 p2 must equal the parent's bit for
    bit: one entry an ulp off fails (chip_smoke.check exits)."""
    mine, theirs = _outs(rng, dt)
    bits = mine[0].view(torch.int16 if dt == "bf16" else torch.int32)
    bits[7, 9] += 1
    with pytest.raises(SystemExit):
        cs.layer_vs_parent("sa_fwd_layer", mine, theirs, affine)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_parent_layer_comparison_fails_beyond_the_sums_bar(rng, dt):
    mine, theirs = _outs(rng, dt)
    mine[2][4] += 2e-4 * float(theirs[2].abs().max())
    with pytest.raises(SystemExit):
        cs.layer_vs_parent("sa_fwd_layer", mine, theirs, False)
