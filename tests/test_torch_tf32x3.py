"""The 3xTF32 split of the tensor-core SA sweeps (csrc/sa_mma.cuh), and
B2a's exact 6xTF32 split, in arithmetic the CPU can check.

B2b (sa_fwd_gram_pool), B3b (sa_bwd_sweep2) and B3c (sa_bwd_sweep3) run
their 64-wide products on tensor cores in TF32, split in three passes: a = hi + lo with
hi = tf32(a), lo = tf32(a - hi), and a b = lo hi' + hi lo' + hi hi' in
f32. This file emulates ``cvt.rna.tf32.f32`` (round the low 13 mantissa
bits to nearest, ties away from zero) and the three-pass product in
torch, at the magnitudes of the main path's h1, h2, dy1, dy2, M2, M3, W3
and [x | 1], and
holds it against a float64 product at the bars chip_smoke.py holds the
kernels to: row products (h2 W3, h2 M3) at rtol 1e-5 / atol 1e-5 x
scale, accumulators (h2^T h2, dy2^T h1) within 1e-4 of their max-abs.
Single-pass TF32 fails those bars: the reason for the three passes.
The emulation lives here only; nothing on the port's path uses it.
"""
import numpy as np
import pytest
import torch

TILE = 64       # rows a kernel sums in f32 before carrying in float64
R = 4096


def tf32(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, round to nearest with
    ties away from zero (on the sign-magnitude bits, adding half of the
    dropped 13 bits and truncating rounds the magnitude half-up)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_3x(a, b):
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm_1x(a, b):
    return tf32(a) @ tf32(b)


def _operands(name):
    rng = np.random.default_rng(0)

    def f(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape))
                                .astype(np.float32))
    h1 = torch.relu(f(R, 64))                 # BN output, then ReLU
    h2 = torch.relu(f(R, 64))
    w3 = f(64, 256, scale=0.125)
    m3 = f(64, 64, scale=0.01)
    dy2 = torch.where(h2 > 0, f(R, 64, scale=1e-3), 0.0)
    m2 = f(64, 64, scale=0.01)
    dy1 = torch.where(h1 > 0, f(R, 64, scale=1e-3), 0.0)
    x1 = torch.cat([f(R, 4), torch.ones(R, 1), torch.zeros(R, 3)], 1)
    return {"h2 W3": (h2, w3, "row"), "h2 M3": (h2, m3, "row"),
            "h2^T h2": (h2.T, h2, "acc"), "dy2^T h1": (dy2.T, h1, "acc"),
            "h1 M2": (h1, m2, "row"), "dy1^T [x | 1]": (dy1.T, x1, "acc")
            }[name]


def _bar(k, a, b, kind):
    """How far past its bar the product k of a and b is (<= 1 passes)."""
    ref = a.double() @ b.double()
    scale = float(ref.abs().max())
    d = (k.double() - ref).abs()
    if kind == "acc":
        return float(d.max()) / (1e-4 * scale)
    return float((d / (1e-5 * ref.abs() + 1e-5 * scale)).max())


def _cut(a, b, kind, rows):
    return (a[:, :rows], b[:rows]) if kind == "acc" else (a[:rows], b)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                         1.0 + 2 ** -9, -(1.0 + 2 ** -10), 1.0])
    assert torch.equal(tf32(x), want)          # ties go away from zero
    y = torch.from_numpy(np.random.default_rng(1).normal(size=1000)
                         .astype(np.float32))
    hi = tf32(y)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((y - hi) / y).abs().max()) <= 2 ** -11
    # hi + lo carries y to ~2^-22: the term 3xTF32 drops (lo lo') is that
    # small.
    assert float(((hi + tf32(y - hi) - y) / y).abs().max()) <= 2 ** -21


NAMES = ["h2 W3", "h2 M3", "h2^T h2", "dy2^T h1", "h1 M2", "dy1^T [x | 1]"]


@pytest.mark.parametrize("rows", [TILE, R])
@pytest.mark.parametrize("name", NAMES)
def test_three_passes_meet_the_bars(name, rows):
    a, b, kind = _operands(name)
    a, b = _cut(a, b, kind, rows)
    assert _bar(mm_3x(a, b), a, b, kind) <= 1.0


@pytest.mark.parametrize("name", NAMES)
def test_one_pass_fails_the_bars(name):
    """At one tile's rows, single-pass TF32 (~2^-11 relative per operand)
    misses every bar by more than the three passes are inside it."""
    a, b, kind = _operands(name)
    a, b = _cut(a, b, kind, TILE)
    assert _bar(mm_1x(a, b), a, b, kind) > 1.0
    assert _bar(mm_1x(a, b), a, b, kind) > 10 * _bar(mm_3x(a, b), a, b, kind)


def test_b3c_dy1_from_three_passes():
    """B3c's dy1 = [h1 > 0] (mq - (h1 M2 + rc2)) with h1 M2 in 3xTF32: the
    ReLU mask comes from the f32 h1 (never from a TF32 value), so it equals
    the twin's; dy1 is within the row bar of the float64 product and as
    close to it as the twin's f32 product."""
    rng = np.random.default_rng(2)

    def f(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape))
                                .astype(np.float32))
    h1 = torch.relu(f(TILE, 64))
    m2, rc2, mq = f(64, 64, scale=0.01), f(64, scale=0.01), f(TILE, 64,
                                                                scale=0.01)
    mask = h1 > 0
    assert torch.equal(mask, tf32(h1) > 0)       # the split keeps the sign
    k = torch.where(mask, mq - (mm_3x(h1, m2) + rc2), 0.0)
    t = torch.where(h1 > 0, mq - (h1 @ m2 + rc2), 0.0)
    ref = torch.where(mask, mq.double() - (h1.double() @ m2.double()
                                           + rc2.double()), 0.0)
    scale = float(ref.abs().max())
    for d in (k, t):
        err = (d.double() - ref).abs()
        assert bool((err <= 1e-5 * ref.abs() + 1e-5 * scale).all())
    assert torch.equal(k != 0, mask) and torch.equal(t != 0, mask)


def _layer12_operands(rows, seed=3):
    """B2a's product at the main path's magnitudes: h1 a BatchNorm output
    after its ReLU, W2 at flax's Dense init (std 1/sqrt(64)), b2 small."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape))
                                .astype(np.float32))
    return torch.relu(f(rows, 64)), f(64, 64, scale=0.125), f(64, scale=0.1)


def _layer12_sums(p2):
    """B2a's sums of p2 and p2^2 in its order: two rows of a lane, then its
    16-row slice (shuffles), summed in f32 over a 64-row tile, the tiles in
    float64."""
    def tiles(v):
        s16 = v.reshape(-1, 16, v.shape[1]).sum(1)            # f32
        return s16.reshape(-1, TILE // 16, v.shape[1]).sum(1).double().sum(0)
    return tiles(p2), tiles(p2 * p2)


@pytest.mark.parametrize("rows", [TILE, R])
def test_b2a_layer12_product_meets_the_bars(rows):
    """B2a's product p2 = h1 W2 + b2 with h1 W2 in 3xTF32 (b2 added after
    the product), as the other sweeps run theirs, within chip_smoke.py's
    row bar of the float64 product, rtol 1e-5 / atol 1e-5 x scale; the
    sums of p2 and p2^2 in the kernel's order within 1e-4 of their max-abs
    of float64's. One pass of TF32 misses the row bar. (The kernel runs
    six passes, below: p2 feeds the layer-2 ReLU decisions.)"""
    h1, w2, b2 = _layer12_operands(rows)
    p2 = mm_3x(h1, w2) + b2
    ref = h1.double() @ w2.double() + b2.double()
    scale = float(ref.abs().max())
    d = (p2.double() - ref).abs()
    assert bool((d <= 1e-5 * ref.abs() + 1e-5 * scale).all())
    s, ss = _layer12_sums(p2)
    for k, r in ((s, ref.sum(0)), (ss, (ref * ref).sum(0))):
        assert float((k - r).abs().max()) <= 1e-4 * float(r.abs().max())
    d1 = (mm_1x(h1, w2) + b2).double() - ref
    assert not bool((d1.abs() <= 1e-5 * ref.abs() + 1e-5 * scale).all())


def split3(a: torch.Tensor):
    """B2a's exact split (csrc/sa_mma.cuh split3): hi = tf32(a), mid =
    tf32(a - hi), lo = (a - hi) - mid, all three exact in f32."""
    hi = tf32(a)
    r = a - hi
    mid = tf32(r)
    return hi, mid, r - mid


#: B2a's six products, small to large: (piece of h1, piece of W2).
SIX = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def mm_6x(a, b):
    """B2a's h1 W2: per 8-wide k step the six piece products summed (the
    tensor cores multiply TF32 pieces exactly; the step's sum is rounded
    to f32 here), and the steps added in f32 with rounding, in order."""
    pa, pb = split3(a), split3(b)
    c = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 8):
        d = sum(pa[i][:, k:k + 8].double() @ pb[j][k:k + 8].double()
                for i, j in SIX)
        c = c + d.float()
    return c


def test_b2a_split3_is_exact():
    """hi + mid + lo is the f32 value itself (11 + 11 + at most 2
    significant bits), every piece a TF32 value, at the magnitudes of h1
    and W2 and at the f32 extremes."""
    rng = np.random.default_rng(4)
    a = np.concatenate([rng.normal(size=4000), rng.normal(size=1000) * 1e-30,
                        rng.normal(size=1000) * 1e30, [0.0, -0.0, 1.0]])
    a = torch.from_numpy(a.astype(np.float32))
    hi, mid, lo = split3(a)
    assert torch.equal(hi.double() + mid.double() + lo.double(), a.double())
    for piece in (hi, mid, lo):
        assert bool(((piece.view(torch.int32) & 0x1FFF) == 0).all())


@pytest.mark.parametrize("rows", [TILE, R])
def test_b2a_six_passes_beat_an_f32_product(rows):
    """B2a's 6xTF32 product p2 = h1 W2 + b2 at the main path's magnitudes:
    within the row bar of float64 and no farther from it, element by
    element at worst and in root mean square, than the f32 product the
    twin takes; its sums of p2 and p2^2 within 1e-4 of their max-abs."""
    h1, w2, b2 = _layer12_operands(rows)
    ref = h1.double() @ w2.double() + b2.double()
    p2 = mm_6x(h1, w2) + b2
    scale = float(ref.abs().max())
    d6 = (p2.double() - ref).abs()
    d32 = ((h1 @ w2 + b2).double() - ref).abs()
    assert bool((d6 <= 1e-5 * ref.abs() + 1e-5 * scale).all())
    assert float(d6.max()) <= float(d32.max())
    assert float(d6.pow(2).mean()) <= float(d32.pow(2).mean())
    s, ss = _layer12_sums(p2)
    for k, r in ((s, ref.sum(0)), (ss, (ref * ref).sum(0))):
        assert float((k - r).abs().max()) <= 1e-4 * float(r.abs().max())


# -- B8a (sa_2sweep.cu bwd2_sweep1 at f32) --------------------------------
# Its three products run in 3xTF32, each sum in steps of its own added to
# the f32 sum round-to-nearest: z's h2 W3 in one step (k = 64, chained in
# the tensor cores), q3 = (gi3 dy3) W3^T in steps of 32 channels (k =
# 256), A3 = dy3^T h2 in k8 steps (k = the rows; one block walks its
# tiles in turn, so A3's chain runs over every row it takes).
B8A_STEP = {"h2 W3": 64, "(gi3 dy3) W3^T": 32, "dy3^T h2": 8}


def mm_3x_steps(a, b, step=8):
    """a @ b as B8a's kernel sums it: per step of ``step`` k the three
    TF32 piece products (exact) summed and rounded to f32, the steps added
    in f32 with rounding, in k order (the tensor cores' truncating adds
    inside a step are not modelled)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    c = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], step):
        s = slice(k, k + step)
        d = (al[:, s].double() @ bh[s].double()
             + ah[:, s].double() @ bl[s].double()
             + ah[:, s].double() @ bh[s].double())
        c = c + d.float()
    return c


def _b8a_operands(name, rows):
    """B8a's products at the main path's magnitudes: h2 after its ReLU, W3
    at flax's Dense init, dy3 the pool's even split of a randn cotangent
    over each 64-row group's ties, the groups padded as ball query pads
    them (the last half repeats the first row, drawn at three times the
    scale: exact ties), gi3 ~ 1."""
    from facl_tpu_torch.ops.sa_bwd import _dy_top
    rng = np.random.default_rng(5)

    def f(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape))
                                .astype(np.float32))
    h2 = torch.relu(f(rows, 64))
    w3 = f(64, 256, scale=0.125)
    z = f(rows, 256)
    zg = z.view(-1, TILE, 256)
    zg[:, 0] *= 3.0                     # often the group's max
    zg[:, TILE // 2:] = zg[:, :1]
    dy3 = _dy_top(z, f(rows // TILE, 256), TILE)
    gi3 = 1.0 + f(256, scale=0.3)
    return {"h2 W3": (h2, w3, "row"),
            "(gi3 dy3) W3^T": (dy3 * gi3, w3.T.contiguous(), "row"),
            "dy3^T h2": (dy3.T.contiguous(), h2, "acc")}[name]


B8A_NAMES = ["h2 W3", "(gi3 dy3) W3^T", "dy3^T h2"]


@pytest.mark.parametrize("rows", [TILE, R])
@pytest.mark.parametrize("name", B8A_NAMES)
def test_b8a_step_products_meet_the_bars(name, rows):
    """B8a's products in its steps, within the bars of
    tests/test_torch_cuda.py's B8a case against float64: rows (z's
    product, q3) at rtol 1e-5 / atol 1e-5 x scale, A3 within 1e-4 of its
    max-abs (over a tile, and over 64 tiles in one chain)."""
    a, b, kind = _b8a_operands(name, rows)
    assert _bar(mm_3x_steps(a, b, B8A_STEP[name]), a, b, kind) <= 1.0
    if kind == "acc":        # the routed split: ~half the rows tie
        assert int((a != 0).sum()) > 4 * (rows // TILE) * 256


@pytest.mark.parametrize("name", B8A_NAMES)
def test_b8a_exact_ties_stay_exact(name):
    """Identical rows of h2 (or dy3) give bit-identical rows of the step
    product wherever they sit: the split and each k8 step depend on the
    row's own values only."""
    a, b, kind = _b8a_operands(name, TILE)
    if kind == "acc":
        a, b = b.T.contiguous(), a.T.contiguous()   # rows of the output
    a = a.clone()
    a[TILE // 2:] = a[:1]
    out = mm_3x_steps(a, b, B8A_STEP[name])
    assert torch.equal(out[TILE // 2:], out[:1].expand(TILE // 2, -1))
