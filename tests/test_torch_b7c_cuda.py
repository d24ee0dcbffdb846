"""B7c, hybrid2's pool sweep on the tensor cores (sa_fwd_pool at f32 in
3xTF32 on wgmma, sa_fwd_pool_bf16 on mma.sync), against its twins on the
card: every pool the sweeps take (sizes dividing 64, 64, and multiples of
64: 128 and 192 walk a group's tiles in order), groups padded with exact
ties, mul3 of both signs, more tiles than blocks (the TMA ring wraps many
times), run to run bit-identical; the sign bookkeeping of the column
negation where mul3 < 0 (W3, b3 and mul3 negated together give the same
bits); a p2 that
is not 16-byte aligned raises (its tiles arrive by TMA bulk copies); and
the hybrid2 stage, card vs CPU at both dtypes, through the kernel.

Marked ``cuda``: each test skips (with its reason) where no card is
present; ``chip_smoke.py`` holds the same kernels at the main path's full
shapes. On a machine with a card:
``python -m pytest tests/test_torch_b7c_cuda.py -m cuda -q``.

Bars (chip_smoke.py phase 2's): f32 pooled at rtol 1e-5 / atol 1e-5 x
scale; bf16 pooled within one bf16 ulp of the twin's on all but 1e-3 of
its entries (where a bf16 rounding upstream goes the other way between the
two summation orders). The stage, card vs CPU: f32 pooled at rtol 1e-4 /
atol 1e-5 and gradients at 2e-4 of their scale (tests/test_torch_cuda.py);
bf16 pooled at rtol = atol = 5e-2, gradients at relative L2 < 0.15, cosine
> 0.99 (tests/test_torch_bf16_cuda.py).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda
BF16 = torch.bfloat16


@pytest.fixture
def rng():
    """tests/conftest.py's, so the file also runs under ``--noconftest``."""
    return np.random.default_rng(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _args(rng, dev, R, pool, dt):
    """B7c's arguments: randn p2 with every other 64-row block padded as
    ball query pads a group (its last half a copy of its first row), mul3
    of both signs."""
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    p2 = rng.normal(size=(R // 64, 64, 64)).astype(np.float32)
    p2[::2, 32:] = p2[::2, :1]
    p2 = t(p2.reshape(R, 64))
    args = (p2.to(BF16) if dt == "bf16" else p2,
            t(0.3 * rng.normal(size=64)), t(rng.normal(size=64)),
            t(0.125 * rng.normal(size=(64, 256))),
            t(0.1 * rng.normal(size=256)), t(0.5 * rng.normal(size=256)),
            t(rng.normal(size=256)), pool)
    assert bool((args[5] < 0).any() and (args[5] > 0).any())
    return args


def _ulp(v):
    _, e = torch.frexp(v.clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v), e - 8)


def _match(args, dt):
    """The kernel against its twin at phase 2's bars; two calls equal."""
    from facl_tpu_torch.ops import sa_fwd as SF
    fn = SF.sa_fwd_pool_bf16 if dt == "bf16" else SF.sa_fwd_pool
    twin = SF.sa_fwd_pool_bf16_plain if dt == "bf16" else \
        SF.sa_fwd_pool_plain
    n = fn.launches
    k, again, tw = fn(*args), fn(*args), twin(*args)
    assert fn.launches == n + 2
    assert torch.equal(k, again)
    assert k.dtype == tw.dtype and k.shape == tw.shape
    if dt == "f32":
        torch.testing.assert_close(k, tw, rtol=1e-5,
                                   atol=1e-5 * float(tw.abs().max()))
        return
    a, b = k.float(), tw.float()
    beyond = (a - b).abs() > _ulp(torch.maximum(a.abs(), b.abs()))
    assert int(beyond.sum()) <= 1e-3 * a.numel()


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pool", [1, 2, 4, 8, 16, 32, 64, 128, 192])
def test_b7c_matches_twins(dev, rng, dt, pool):
    _match(_args(rng, dev, 64 * 192, pool, dt), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("R,pool", [(64 * 1037, 64), (128 * 1031, 128)])
def test_b7c_many_tiles_a_block(dev, rng, dt, R, pool):
    """Thousands of tiles over one block an SM: each block's TMA ring of
    stages wraps many times, and a block walks several pool groups."""
    _match(_args(rng, dev, R, pool, dt), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("pool", [16, 64, 128])
def test_b7c_mirrored_layer3_gives_the_same_bits(dev, rng, dt, pool):
    """Negating W3, b3 and mul3 together leaves every z as it was (the
    roundings are symmetric), and the pooled rows come out bit-identical.
    The kernel negates W3's column where mul3 < 0, so the tensor cores see
    the same operands in both runs: this holds the sign bookkeeping around
    them (which columns are negated, the max of the negated sums, p3's
    sign restored before the affine) at both signs of every channel.
    That the sums of negated products are the negated sums is held by
    chip_ablate.py b7c, against a build that takes a min instead."""
    from facl_tpu_torch.ops import sa_fwd as SF
    p2, mul2, shift2, w3, b3, mul3, shift3, _ = _args(rng, dev, 64 * 192,
                                                      pool, dt)
    fn = SF.sa_fwd_pool_bf16 if dt == "bf16" else SF.sa_fwd_pool
    a = fn(p2, mul2, shift2, w3, b3, mul3, shift3, pool)
    b = fn(p2, mul2, shift2, -w3, -b3, -mul3, shift3, pool)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_b7c_unaligned_p2_raises(dev, rng, dt):
    """p2 one element past a 16-byte boundary: the wrapper raises (the
    kernel stages p2 by 16-byte TMA bulk copies); the same rows aligned
    run."""
    from facl_tpu_torch.ops import sa_fwd as SF
    args = _args(rng, dev, 64 * 8, 64, dt)
    p2 = args[0]
    buf = torch.empty(p2.numel() + 8, dtype=p2.dtype, device=dev)
    off = buf[1:1 + p2.numel()].view_as(p2)
    off.copy_(p2)
    assert off.data_ptr() % 16
    fn = SF.sa_fwd_pool_bf16 if dt == "bf16" else SF.sa_fwd_pool
    with pytest.raises(ValueError, match="16-byte"):
        fn(off, *args[1:])
    _match(args, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("K", [64, 128])
def test_hybrid2_stage_card_vs_cpu(dev, rng, dt, K):
    """The hybrid2 stage (sa_train_pfwd), card (B7c once a call) vs CPU
    (the twins), forward and gradients at the module's bars."""
    from facl_tpu_torch.ops import sa_fwd as SF
    from facl_tpu_torch.ops.fused_sa import SALayerParams
    x = rng.normal(size=(4, 16, K, 4)).astype(np.float32)
    layers, cin = [], 4
    for w in (64, 64, 256):
        layers.append([rng.normal(size=(cin, w), scale=0.3),
                       rng.normal(size=(w,), scale=0.1),
                       1.0 + 0.3 * rng.normal(size=(w,)),
                       rng.normal(size=(w,), scale=0.1)])
        cin = w
    layers[2][2][::3] *= -1.0             # mul3 < 0 on a third of channels
    wvec = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    dtype = BF16 if dt == "bf16" else torch.float32
    fn = SF.sa_fwd_pool_bf16 if dt == "bf16" else SF.sa_fwd_pool
    out = {}
    for d in ("cpu", dev):
        lp = [SALayerParams(*(torch.tensor(a, dtype=torch.float32,
                                           device=d, requires_grad=True)
                              for a in layer)) for layer in layers]
        n = fn.launches
        pooled, _ = SF.sa_train_pfwd(torch.from_numpy(x).to(d), lp,
                                     dtype=dtype)
        assert fn.launches == n + (d != "cpu")
        assert pooled.dtype == dtype
        (torch.sin(pooled.float()) * wvec.to(d)).sum().backward()
        out[str(d)] = (pooled.detach().float().cpu(),
                       [t.grad.cpu() for layer in lp for t in layer])
    (pc, gc), (pg, gg) = out["cpu"], out[str(dev)]
    if dt == "f32":
        torch.testing.assert_close(pg, pc, rtol=1e-4, atol=1e-5)
    else:
        torch.testing.assert_close(pg, pc, rtol=5e-2, atol=5e-2)
    gscale = max(float(t.abs().max()) for t in gc)
    for i, (a, b) in enumerate(zip(gg, gc)):
        if i % 4 == 1:     # Dense bias before BN: exact gradient is zero
            if dt == "f32":
                assert float(a.abs().max()) < 1e-4 * gscale
            continue
        if dt == "f32":
            scale = max(float(b.abs().max()), 1e-8)
            torch.testing.assert_close(a / scale, b / scale, rtol=0,
                                       atol=2e-4)
        else:
            a, b = a.double().flatten(), b.double().flatten()
            assert float((a - b).norm() / b.norm()) < 0.15
            assert float(a @ b / (a.norm() * b.norm())) > 0.99
