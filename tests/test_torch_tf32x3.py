"""The 3xTF32 split of the tensor-core SA sweeps (csrc/sa_mma.cuh), in
arithmetic the CPU can check.

B2b (sa_fwd_gram_pool) and B3b (sa_bwd_sweep2) run their 64-wide
products on tensor cores in TF32, split in three passes: a = hi + lo with
hi = tf32(a), lo = tf32(a - hi), and a b = lo hi' + hi lo' + hi hi' in
f32. This file emulates ``cvt.rna.tf32.f32`` (round the low 13 mantissa
bits to nearest, ties away from zero) and the three-pass product in
torch, at the magnitudes of the main path's h1, h2, dy2, M3 and W3, and
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
    return {"h2 W3": (h2, w3, "row"), "h2 M3": (h2, m3, "row"),
            "h2^T h2": (h2.T, h2, "acc"), "dy2^T h1": (dy2.T, h1, "acc")}[name]


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


@pytest.mark.parametrize("rows", [TILE, R])
@pytest.mark.parametrize("name", ["h2 W3", "h2 M3", "h2^T h2", "dy2^T h1"])
def test_three_passes_meet_the_bars(name, rows):
    a, b, kind = _operands(name)
    a, b = _cut(a, b, kind, rows)
    assert _bar(mm_3x(a, b), a, b, kind) <= 1.0


@pytest.mark.parametrize("name", ["h2 W3", "h2 M3", "h2^T h2", "dy2^T h1"])
def test_one_pass_fails_the_bars(name):
    """At one tile's rows, single-pass TF32 (~2^-11 relative per operand)
    misses every bar by more than the three passes are inside it."""
    a, b, kind = _operands(name)
    a, b = _cut(a, b, kind, TILE)
    assert _bar(mm_1x(a, b), a, b, kind) > 1.0
    assert _bar(mm_1x(a, b), a, b, kind) > 10 * _bar(mm_3x(a, b), a, b, kind)
