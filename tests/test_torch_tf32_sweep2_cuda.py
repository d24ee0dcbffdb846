"""The f32 B6 (sa_bwd_sweep2_full, x channel-major) and B8b
(sa_bwd2_sweep2, x row-major) of the TF32 tensor-core kernel
(csrc/sa_2sweep.cu, bwd2_sweep2_tf32_kernel) against their twins on the
card: at C0 = 1, 4 and 7; at 1,037 row tiles (an odd count, many steps a
block), at 5 tiles (fewer tiles than SMs: a block a tile), at N = 20 (x
channel-major in 4-row pieces of one cloud) and N = 6 (x read value by
value); on p1, p2, q3 and x 4 bytes off 16-byte alignment (4-byte
copies); two calls bit-identical.

Marked ``cuda``: each test skips (with its reason) where no card is
present; ``chip_smoke.py`` holds the same kernels at the main path's full
shapes. On a machine with a card:
``python -m pytest tests/test_torch_tf32_sweep2_cuda.py -m cuda -q``.

Bars: chip_smoke.py phase 2's f32 bar, every accumulator within 1e-4 of
the twin's max-abs (the kernel sums its 3xTF32 products in another order
than the twin), cnt1 exact. The layer-1 masks are the forward's: B8b's
twin makes them the same way, but B6's twin takes h1 by an x @ w1 matmul
where the kernel keeps the forward's k-order chain, so a row whose h1 sits
at the ReLU threshold can count differently; none does at these shapes
(chip_ablate.py b8b_f32 counts one of 64 cnt1 entries apart on 2.6 M randn
rows, as for the kernel this one replaced).
"""
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

#: chip_smoke.py phase 2's f32 bar for an accumulator (acc_err).
F32_BAR = 1e-4


@pytest.fixture
def rng():
    """tests/conftest.py's, so the file also runs under ``--noconftest``
    where JAX (which the conftest imports) is not installed."""
    return np.random.default_rng(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(rng, dev, C0, R):
    """B6's and B8b's f32 arguments on R random rows, p1 and p2 from the
    forward's layers (sa_fwd_layer's twin), q3 random."""
    from facl_tpu_torch.ops import sa_fwd as SF
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    vec = lambda n, s=1.0: t(s * rng.normal(size=(n,)))
    w1, b1 = t(rng.normal(size=(C0, 64), scale=0.3)), vec(64, 0.1)
    w2 = t(rng.normal(size=(64, 64), scale=0.3))
    xr = t(rng.normal(size=(R, C0)))
    mul1, shift1, mul2, shift2 = vec(64, 2), vec(64), vec(64, 2), vec(64)
    p1 = SF.sa_fwd_layer_plain(xr, w1, b1)[0]
    p2 = SF.sa_fwd_layer_plain(p1, w2, vec(64, 0.1), mul1, shift1)[0]
    q3 = vec(R * 64).view(R, 64)
    tail = (p2, mul2, shift2, q3, t(0.01 * rng.normal(size=(64, 64))),
            vec(64, 0.1), vec(64), w2)
    return xr, w1, b1, mul1, shift1, p1, tail


def _match(fn, args):
    """A sweep-2 kernel against its twin: cnt1 exact, every accumulator
    within F32_BAR of its max-abs; two calls bit-identical."""
    plain = getattr(sys.modules[fn.__module__], fn.__name__ + "_plain")
    k, again, tw = fn(*args), fn(*args), plain(*args)
    assert set(k) == set(tw)
    assert all(torch.equal(k[n], again[n]) for n in k)
    assert torch.equal(k["cnt1"], tw["cnt1"])
    for n in tw:
        err = float((k[n] - tw[n]).abs().max())
        assert err <= F32_BAR * float(tw[n].abs().max()), (n, err)


@pytest.mark.parametrize("C0", [1, 4, 7])
@pytest.mark.parametrize("B,N", [(1, 64 * 1037), (5, 64), (16, 20),
                                 (32, 6)])
def test_tf32_sweep2_matches_twins(dev, rng, C0, B, N):
    from facl_tpu_torch.ops import sa_bwd as SB
    from facl_tpu_torch.ops import sa_pair as SP
    R = B * N
    xr, w1, b1, mul1, shift1, p1, tail = _inputs(rng, dev, C0, R)
    x3 = xr.view(B, N, C0).transpose(1, 2).contiguous()
    _match(SB.sa_bwd2_sweep2, (xr, p1, mul1, shift1, *tail))
    _match(SP.sa_bwd_sweep2_full, (x3, w1, b1, mul1, shift1, *tail))


@pytest.mark.parametrize("form", ["B8b", "B6"])
def test_tf32_sweep2_unaligned_rows(dev, rng, form):
    """Rows 4 bytes off 16-byte alignment (each of x, p1, p2 and q3 in
    turn) arrive by 4-byte copies and match, as the CUDA-core kernel this
    one replaced took them."""
    from facl_tpu_torch.ops import sa_bwd as SB
    from facl_tpu_torch.ops import sa_pair as SP
    R, C0 = 64 * 7, 4
    xr, w1, b1, mul1, shift1, p1, tail = _inputs(rng, dev, C0, R)

    def shifted(a):          # the same values, 4 bytes off alignment
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=dev)
        buf[1:] = a.reshape(-1)
        out = buf[1:].view(a.shape)
        assert out.data_ptr() % 16 != 0
        return out
    if form == "B8b":
        fn, args, places = SB.sa_bwd2_sweep2, [xr, p1, mul1, shift1, *tail], \
            (0, 1, 4, 7)
    else:
        x3 = xr.view(7, 64, C0).transpose(1, 2).contiguous()
        fn, args, places = SP.sa_bwd_sweep2_full, \
            [x3, w1, b1, mul1, shift1, *tail], (0, 5, 8)
    for i in places:
        moved = list(args)
        moved[i] = shifted(args[i])
        _match(fn, moved)
