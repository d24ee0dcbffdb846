"""The order of sums of B7c, hybrid2's pool sweep (sa_fwd_pool and
sa_fwd_pool_bf16), on the tensor cores, modelled in torch on the CPU
(``b7c_f32_model``, ``b7c_bf16_model``, with the twins' signatures), held
against the f32 and bf16 twins (ops/sa_fwd.py::sa_fwd_pool_plain,
sa_fwd_pool_bf16_plain) and against the JAX pool sweep they port
(facl_tpu/ops/pallas/sa_fwd.py::_make_pool_sweep, pallas_call :242), run
in interpret mode.

On the card (facl_tpu_torch/ops/csrc/sa_2sweep.cu, fwd_pool_kernel<BF,
LP>) each warp forms p3^T = W3^T h2^T for its
channels, W3's column negated where mul3 < 0 (its sign bit set), and
reduces each (group, channel)'s max of those sums; the layer-3 affine,
the roundings and the ReLU are then applied to that one value, negated
back. They are monotone in p3, so the result is the twin's per-row chain
at the group's largest (or, where mul3 < 0, smallest) p3:

  * f32: h2 and W3 split as tf32_mma.cuh's split splits them (hi =
    tf32(a), lo = tf32(a - hi), each rounded to nearest:
    tests/test_torch_tf32x3.py::tf32), the three passes lo hi' + hi lo' +
    hi hi' of the 64-deep product chained in the tensor cores (modelled as
    the exact sum of the piece products rounded to f32 once: the tensor
    cores' truncating adds inside the chain are not modelled);
  * bf16: h2 = relu(bf16(p2 mul2 + shift2)) and bf16(W3), exact products
    summed in f32 one k16 step at a time (each step exact, rounded once,
    added to the f32 accumulator in k order), p3 = bf16(acc) + bf16(b3),
    z rounded to bf16 before the ReLU.

So the bars the card is held to can be checked against that order here:
at bench.py's magnitudes (the model's SA weights at full width, randn
clouds grouped at S = K = 64 and at the fine variant's S = 32, K = 128,
through hybrid2's twins), on rows whose h2 pre-activation or z sits
within an ulp of 0, and on groups padded with exact ties (half of each
group a copy of its first row), each model sits within chip_smoke.py
phase 2's bars of its twin (f32: rtol 1e-5 / atol 1e-5 x scale; bf16:
one bf16 ulp outside at most 1e-3 of the entries, bf16_flips); on
tests/test_torch_bf16_sa.py's tiny shapes it sits within that file's
tolerances of the JAX pool sweep (f32: phase 2's bar; bf16: at most 1%
of the entries one bf16 ulp apart), with and without negative layer-3
scales.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu.ops.pallas.sa_bwd import _fold_affine as jax_fold_affine
from facl_tpu.ops.pallas.sa_fwd import sa_forward_pallas
from facl_tpu_torch.ops import sa_fwd as SF
from facl_tpu_torch.ops.sa_bwd import _fold_affine, _h_bf16, _h_from_p, \
    _rb
from tests.test_torch_bf16_mma_order import _k16, cs
from tests.test_torch_bf16_sa import BF, C0, EPS, K as K_TINY, \
    _bf16_rows, _setup, _t
from tests.test_torch_cuda import padded_groups
from tests.test_torch_tf32x3 import tf32

BF16 = torch.bfloat16


# -- the models -------------------------------------------------------------

def _split(a):
    """tf32_mma.cuh's split: hi and lo = a - hi, each rounded to TF32."""
    hi = tf32(a)
    return hi, tf32(a - hi)


def _signs(mul3):
    """-1 at the channels whose W3 column the kernel negates (mul3's sign
    bit set), else 1."""
    return torch.where(torch.signbit(mul3), -1.0, 1.0)


def _group_extreme(acc, s, pool: int):
    """The kernel's reduction of the sums acc of negated columns: each
    (group, channel)'s max, negated back (p3's smallest where s < 0)."""
    return acc.reshape(-1, pool, acc.shape[1]).amax(1) * s


def b7c_f32_model(p2, mul2, shift2, w3, b3, mul3, shift3, pool: int):
    """B7c at f32 in the kernel's order, with its twin's signature
    (ops/sa_fwd.py::sa_fwd_pool_plain)."""
    h2 = _h_from_p(p2, mul2, shift2)
    s = _signs(mul3)
    (hh, hl), (wh, wl) = _split(h2), _split(w3 * s)
    acc = (hl.double() @ wh.double() + hh.double() @ wl.double()
           + hh.double() @ wh.double()).float()
    p3 = _group_extreme(acc, s, pool)
    return torch.relu((p3 + b3) * mul3 + shift3)


def b7c_bf16_model(p2, mul2, shift2, w3, b3, mul3, shift3, pool: int):
    """B7c at bf16 in the kernel's order, with its twin's signature
    (ops/sa_fwd.py::sa_fwd_pool_bf16_plain)."""
    h2 = _h_bf16(p2, mul2, shift2)
    s = _signs(mul3)
    p3 = _rb(_group_extreme(_k16(h2, _rb(w3) * s), s, pool)) + _rb(b3)
    return torch.relu(_rb(p3 * mul3 + shift3)).to(BF16)


MODELS = {"f32": (b7c_f32_model, SF.sa_fwd_pool_plain),
          "bf16": (b7c_bf16_model, SF.sa_fwd_pool_bf16_plain)}


def _within_bars(dt, args):
    """The model against its twin at phase 2's bar; returns the bf16
    entries beyond one ulp (0 at f32)."""
    model, twin = (f(*args) for f in MODELS[dt])
    if dt == "f32":
        cs.row_err(model, twin, "B7c pooled")
        return 0
    return cs.bf16_flips(model, twin, "B7c bf16 pooled")[0]


# -- inputs -----------------------------------------------------------------

def _bench_args(S, K, dt, clouds=4):
    """B7c's arguments on hybrid2's forward (the twins) of bench.py's
    magnitudes: the model's SA weights at full width, randn clouds grouped
    (B1's twin) and centred, x in ``dt``."""
    from facl_tpu_torch.ops import select as SEL
    from facl_tpu_torch.train import Trainer
    model = Trainer(cs._cfg(2), 100, device="cpu").init_state(cs.SEED).model
    lp1, lp2, lp3 = [SF.SALayerParams(*(t.detach() for t in lp))
                     for lp in model.sa_stage.layers()]
    g = torch.Generator().manual_seed(cs.SEED)
    flat = torch.randn(clouds, 512, 4, generator=g)
    with torch.no_grad():
        grouped, _ = SEL.select_gather(flat, S, K, 0.06)
    grouped[:, :3] -= flat[:, :S, :3].transpose(1, 2)[..., None]
    R = clouds * S * K
    x = grouped.reshape(clouds, 4, S * K).transpose(1, 2).reshape(R, 4)
    bf = dt == "bf16"
    layer = SF.sa_fwd_layer_bf16_plain if bf else SF.sa_fwd_layer_plain
    gram = SF.sa_fwd_gram_bf16_plain if bf else SF.sa_fwd_gram_plain
    p1, s1, ss1 = layer(x.to(BF16) if bf else x.contiguous(), lp1.kernel,
                        lp1.bias)
    mul1, shift1 = _fold_affine(lp1, *SF._finalize(s1, ss1, R), EPS)
    p2, s2, ss2 = layer(p1, lp2.kernel, lp2.bias, mul1, shift1)
    m2, v2 = SF._finalize(s2, ss2, R)
    mul2, shift2 = _fold_affine(lp2, m2, v2, EPS)
    G2, ch2 = gram(p2, mul2, shift2)
    mul3, shift3 = _fold_affine(
        lp3, *SF._moments_from_gram(G2, ch2, lp3.kernel, lp3.bias, R), EPS)
    return p2, mul2, shift2, lp3.kernel, lp3.bias, mul3, shift3, K


def _edge_args(rng, dt, K=64, groups=48):
    """Groups padded with exact ties (padded_groups: half of each group a
    copy of its first row), a third of p2's entries at an h2
    pre-activation within an ulp of 0 (p2 at -shift2 / mul2, nudged by an
    ulp either way or not), and, for a quarter of the channels, shift3 set
    so that z is 0 at the first row of one group (another group for each
    channel), a row its padding repeats; mul3 of both signs. Returns
    (B7c's arguments, those rows by channel, the chosen channels)."""
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.normal(size=s)).astype(np.float32))
    C2, C3 = 64, 256
    R = groups * K
    mul2, shift2 = 1.0 + f(C2, sc=0.3), f(C2, sc=0.2)
    p2 = torch.from_numpy(padded_groups(rng, R, K, C2))
    zero = (-shift2 / mul2).expand(R, C2)
    at = torch.from_numpy(rng.random(size=(R, C2)) < 1 / 3)
    step = torch.from_numpy(rng.integers(-1, 2, size=(R, C2)))
    if dt == "bf16":
        bits = zero.to(BF16).contiguous().view(torch.int16)
        near = (bits + step.to(torch.int16)).view(BF16)
        p2 = torch.where(at, near, p2.to(BF16))
        h2 = _h_bf16(p2, mul2, shift2)
    else:
        p2 = torch.where(at, torch.nextafter(zero, zero + step), p2)
        h2 = _h_from_p(p2, mul2, shift2)
    w3, b3, mul3 = f(C2, C3, sc=0.125), f(C3, sc=0.1), f(C3, sc=0.5)
    p3 = h2 @ w3 + b3 if dt == "f32" else _rb(h2 @ _rb(w3)) + _rb(b3)
    ch = torch.arange(C3)
    rows = (ch * 7) % groups * K
    sel = torch.from_numpy(rng.random(size=C3) < 0.25)
    shift3 = torch.where(sel, -(p3[rows, ch] * mul3), f(C3))
    return (p2.contiguous(), mul2, shift2, w3, b3, mul3, shift3, K), rows, \
        sel


# -- the models against the twins at phase 2's bars -------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("S,K", [(64, 64), (32, 128)])
def test_b7c_model_within_phase2_bars_at_bench_magnitudes(S, K, dt):
    _within_bars(dt, _bench_args(S, K, dt))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("K", [64, 128])
def test_b7c_model_within_phase2_bars_at_zero_and_exact_ties(rng, dt, K):
    args, rows, sel = _edge_args(rng, dt, K)
    p2, mul2, shift2, w3, b3, mul3, shift3, _ = args
    ulp = 2.0 ** -7 if dt == "bf16" else 2.0 ** -20
    pre = (p2.float() * mul2 + shift2).abs()
    assert int((pre <= ulp * float(shift2.abs().max())).sum()) > \
        0.2 * pre.numel()
    h2 = _h_bf16(p2, mul2, shift2) if dt == "bf16" else \
        _h_from_p(p2, mul2, shift2)
    p3 = h2 @ w3 + b3 if dt == "f32" else _rb(h2 @ _rb(w3)) + _rb(b3)
    z = p3 * mul3 + shift3
    at0 = z[rows, torch.arange(256)].abs() <= 1e-5 * float(z.abs().max())
    assert int((at0 & sel).sum()) >= 32
    assert bool((mul3 < 0).any() and (mul3 > 0).any())
    _within_bars(dt, args)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_b7c_group_extreme_equals_the_per_row_chain(rng, dt):
    """The kernel's shortcut (the affine, roundings and ReLU applied to a
    group's extreme p3 alone) against the same sums taken through the
    twin's per-row chain, bit for bit, at pools 1-64 and mul3 of both
    signs (zero included)."""
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.normal(size=s)).astype(np.float32))
    p3 = f(64 * 24, 256, sc=3.0)
    if dt == "bf16":
        p3 = _rb(p3)
    p3[64:128] = p3[64]                     # a group of exact ties
    b3, mul3, shift3 = f(256, sc=0.1), f(256), f(256)
    mul3[::17] = 0.0
    mul3[5::17] = -0.0
    r = _rb if dt == "bf16" else (lambda v: v)
    s = _signs(mul3)
    for pool in (1, 2, 4, 8, 16, 32, 64):
        rows = torch.relu(r((p3 + r(b3)) * mul3 + shift3))
        want = rows.reshape(-1, pool, 256).amax(1)
        ext = _group_extreme(p3 * s, s, pool)
        got = torch.relu(r((ext + r(b3)) * mul3 + shift3))
        assert torch.equal(got, want), pool


# -- the models against the JAX pool sweep (interpret mode) -----------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("negative_scale", [False, True])
def test_b7c_model_matches_jax_pool_sweep(rng, dt, negative_scale):
    """Each model fed the JAX side's own inputs (hybrid2's forward at the
    dtype: its p2 and statistics) against the pooled rows of
    sa_forward_pallas in interpret mode."""
    x, layers = _setup(rng, negative_scale)
    jdt = BF if dt == "bf16" else jnp.float32
    rows = jnp.asarray(x.transpose(0, 2, 3, 1).reshape(-1, C0)).astype(jdt)
    jpooled, stats, _, jp2 = sa_forward_pallas(rows, layers, K_TINY, EPS,
                                               jdt, True)
    _, lp2, lp3 = layers
    (_, _), (m2, v2), (m3, v3) = stats
    mul2, shift2 = (_t(a) for a in jax_fold_affine(lp2, m2, v2, EPS))
    mul3, shift3 = (_t(a) for a in jax_fold_affine(lp3, m3, v3, EPS))
    if negative_scale:
        assert bool((mul3 < 0).any())
    p2 = _t(jp2).to(BF16) if dt == "bf16" else _t(jp2)
    model = MODELS[dt][0](p2, mul2, shift2, _t(lp3.kernel), _t(lp3.bias),
                          mul3, shift3, K_TINY)
    if dt == "bf16":
        _bf16_rows(model, _t(jpooled), "pooled")
    else:
        cs.row_err(model, _t(jpooled), "pooled")


# -- chip_smoke.py --parent: the f32 B7c against the parent's ----------------

def _pooled_pair(rng, P=40, C=256):
    t = torch.from_numpy(np.abs(rng.normal(size=(P, C))).astype(np.float32))
    return t, t.clone()


def test_parent_pool_comparison_passes_within_the_f32_bar(rng):
    """pool_vs_parent takes pooled rows within phase 2's f32 bar of the
    parent's (another order of sums moves them by a few f32 ulps)."""
    mine, theirs = _pooled_pair(rng)
    mine[3, 7] = torch.nextafter(mine[3, 7], torch.tensor(1e30))
    mine[5] *= 1.0 + 2.0 ** -22
    note = cs.pool_vs_parent("sa_fwd_pool", [mine], [theirs])
    assert "within phase 2's f32 bar" in note


def test_parent_pool_comparison_fails_beyond_the_f32_bar(rng):
    """One pooled entry 1e-4 of the scale off the parent's: pool_vs_parent
    fails (chip_smoke.check exits)."""
    mine, theirs = _pooled_pair(rng)
    mine[2, 9] += 1e-4 * float(theirs.abs().max())
    with pytest.raises(SystemExit):
        cs.pool_vs_parent("sa_fwd_pool", [mine], [theirs])
