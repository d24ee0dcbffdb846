"""B7a, hybrid2's layer sweep (sa_fwd_layer, sa_fwd_layer_bf16; kernels in
csrc/sa_layer.cu), against its twins on the card: both call shapes (x ->
p1 at every cin the kernels take, 1..7; p1 -> p2) at both dtypes; fewer
warp steps than the grid has warps, one 64-row tile, and thousands of
tiles over the grid (uneven shares: a warp's steps, 32 or 16 rows, divide
the 64 that R is a multiple of, so R leaves no partial step); run to run
bit-identical; p1 at both dtypes and the f32 p2 bit-equal to the k-order
chain of FMAs from +0 (fma32: one rounding a step, exactly); an input
that is not 16-byte aligned raises (its rows arrive by 16-byte cp.async
copies); and the hybrid2 stage, card vs CPU at K = 64 and K = 128, through
the kernels.

Marked ``cuda``: each test skips (with its reason) where no card is
present; ``chip_smoke.py`` holds the same kernels at the main path's full
shapes. On a machine with a card:
``python -m pytest tests/test_torch_b7a_cuda.py -m cuda -q``.

Bars (chip_smoke.py phase 2's): f32 rows at rtol 1e-5 / atol 1e-5 x
scale, the sums within 1e-4 of their max-abs; bf16 rows within one bf16
ulp of the twin's on all but 1e-3 of their entries (a bf16 rounding goes
the other way between two orders of sums), the sums within ACC2_BAR
(3e-5) of their max-abs. The stage, card vs CPU: f32 pooled at rtol 1e-4 /
atol 1e-5 and gradients at 2e-4 of their scale (tests/test_torch_cuda.py);
bf16 pooled at rtol = atol = 5e-2, gradients at relative L2 < 0.15, cosine
> 0.99 (tests/test_torch_bf16_cuda.py).
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda
BF16 = torch.bfloat16
ACC2_BAR = 3e-5


def fma32(a, b, c):
    """fmaf(a, b, c) of f32 tensors, a b + c rounded to f32 once: the
    product is exact in float64, s = a b + c there with its TwoSum error
    e, and where s lands on an f32 midpoint e decides the side."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    r = s.float()
    rd = r.double()
    other = torch.nextafter(r, torch.where(s > rd, torch.inf, -torch.inf)
                            .float())
    mid = (s != rd) & ((s - rd).abs() * 2 == (other.double() - rd).abs())
    toward = mid & (e != 0) & ((e > 0) == (s > rd))
    return torch.where(toward, other, r)


def fma_chain(h, w):
    """h (R, k) w (k, n) summed in k order by fmaf from +0."""
    acc = torch.zeros(h.shape[0], w.shape[1], device=h.device)
    for k in range(h.shape[1]):
        acc = fma32(h[:, k:k + 1].expand_as(acc), w[k].expand_as(acc), acc)
    return acc


@pytest.fixture
def rng():
    """tests/conftest.py's, so the file also runs under ``--noconftest``."""
    return np.random.default_rng(0)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _t(rng, dev, *shape, sc=1.0):
    return torch.tensor(sc * rng.normal(size=shape), dtype=torch.float32,
                        device=dev)


def _args(rng, dev, R, dt, cin=None):
    """x -> p1 (cin channels) or, with cin None, p1 -> p2 on randn p1 with
    a BatchNorm-like affine (a third of h1 zero)."""
    if cin is not None:
        x = _t(rng, dev, R, cin)
        return (x.to(BF16) if dt == "bf16" else x, _t(rng, dev, cin, 64,
                                                       sc=0.5),
                _t(rng, dev, 64, sc=0.1))
    p1 = _t(rng, dev, R, 64, sc=2.0) + 0.5
    mul1 = 1.0 + _t(rng, dev, 64, sc=0.2)
    return (p1.to(BF16) if dt == "bf16" else p1, _t(rng, dev, 64, 64,
                                                    sc=0.125),
            _t(rng, dev, 64, sc=0.1), mul1, -0.5 * mul1)


def _fns(dt):
    from facl_tpu_torch.ops import sa_fwd as SF
    if dt == "bf16":
        return SF.sa_fwd_layer_bf16, SF.sa_fwd_layer_bf16_plain
    return SF.sa_fwd_layer, SF.sa_fwd_layer_plain


def _ulp(v):
    _, e = torch.frexp(v.clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v), e - 8)


def _match(args, dt):
    """The kernel against its twin at phase 2's bars; two calls equal.
    Returns the kernel's outputs."""
    fn, twin = _fns(dt)
    n = fn.launches
    k, again, tw = fn(*args), fn(*args), twin(*args)
    assert fn.launches == n + 2
    assert all(torch.equal(a, b) for a, b in zip(k, again))
    assert k[0].dtype == tw[0].dtype and k[0].shape == tw[0].shape
    bar = 1e-4 if dt == "f32" else ACC2_BAR
    for a, b in zip(k[1:], tw[1:]):
        assert float((a - b).abs().max()) <= bar * float(b.abs().max())
    if dt == "f32":
        torch.testing.assert_close(k[0], tw[0], rtol=1e-5,
                                   atol=1e-5 * float(tw[0].abs().max()))
        return k
    a, b = k[0].float(), tw[0].float()
    beyond = (a - b).abs() > _ulp(torch.maximum(a.abs(), b.abs()))
    assert int(beyond.sum()) <= 1e-3 * a.numel()
    return k


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("cin", [1, 2, 3, 4, 5, 6, 7, None])
def test_b7a_matches_twins(dev, rng, dt, cin):
    _match(_args(rng, dev, 64 * 192, dt, cin), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("cin", [4, None])
@pytest.mark.parametrize("tiles", [1, 37, 1037, 10007])
def test_b7a_steps_over_the_grid(dev, rng, dt, cin, tiles):
    """One 64-row tile (most warps idle), fewer steps than warps, and
    thousands of tiles: every warp's stage ring wraps many times, the
    warps' shares of steps uneven."""
    _match(_args(rng, dev, 64 * tiles, dt, cin), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("cin", [1, 4, 7])
def test_b7a_p1_is_the_k_order_chain(dev, rng, dt, cin):
    """p1 = the k-order FMA chain from +0, + b (at bf16 with W and b
    rounded, the chain rounded before b is added), bit for bit: the form
    the kernel replaces computed the same chain."""
    fn, _ = _fns(dt)
    x, w, b = _args(rng, dev, 64 * 37, dt, cin)
    x[::5] = 0.0
    p = fn(x, w, b)[0]
    if dt == "bf16":
        rb = lambda v: v.to(BF16).float()
        want = (rb(fma_chain(x.float(), rb(w))) + rb(b)).to(BF16)
        assert torch.equal(p.view(torch.int16), want.view(torch.int16))
    else:
        want = fma_chain(x, w) + b
        assert torch.equal(p.view(torch.int32), want.view(torch.int32))


def test_b7a_f32_p2_is_the_k_order_chain(dev, rng):
    """The f32 p2 = the k-order FMA chain over h1's 64 columns from +0, +
    b2, bit for bit (h1 = relu(p1 mul1 + shift1), each op rounded)."""
    fn, _ = _fns("f32")
    p1, w, b, mul, shift = _args(rng, dev, 64 * 37, "f32")
    p = fn(p1, w, b, mul, shift)[0]
    want = fma_chain(torch.relu(p1 * mul + shift), w) + b
    assert torch.equal(p.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("cin", [4, None])
def test_b7a_unaligned_input_raises(dev, rng, dt, cin):
    """The input one element past a 16-byte boundary: the wrapper raises
    (the kernels copy rows by 16-byte cp.async); the same rows aligned
    run."""
    fn, _ = _fns(dt)
    args = _args(rng, dev, 64 * 8, dt, cin)
    inp = args[0]
    buf = torch.empty(inp.numel() + 8, dtype=inp.dtype, device=dev)
    off = buf[1:1 + inp.numel()].view_as(inp)
    off.copy_(inp)
    assert off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        fn(off, *args[1:])
    _match(args, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("K", [64, 128])
def test_hybrid2_stage_card_vs_cpu(dev, rng, dt, K):
    """The hybrid2 stage (sa_train_pfwd), card (B7a twice a call) vs CPU
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
    wvec = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    dtype = BF16 if dt == "bf16" else torch.float32
    fn = _fns(dt)[0]
    out = {}
    for d in ("cpu", dev):
        lp = [SALayerParams(*(torch.tensor(a, dtype=torch.float32,
                                           device=d, requires_grad=True)
                              for a in layer)) for layer in layers]
        n = fn.launches
        pooled, _ = SF.sa_train_pfwd(torch.from_numpy(x).to(d), lp,
                                     dtype=dtype)
        assert fn.launches == n + 2 * (d != "cpu")
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
