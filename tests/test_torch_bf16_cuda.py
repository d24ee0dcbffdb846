"""The bf16 forms of the pair3 sweeps (B2a, B2b, B3a, B3b, B3c at
compute_dtype bfloat16; each also at uneven row counts, B2b and B3b at
unaligned rows), of B6, B7 and B8 (pair's sweep 2, hybrid2's
forward, the two-sweep backward) and of B9 (the pallas stage's eight
sweeps) against their bf16 twins, on the card; and the bf16 pair3 and
pallas stages, card vs CPU.

Marked ``cuda``: each test skips (with its reason) where no card is
present; ``chip_smoke.py`` holds the same kernels at the main path's full
shapes. On a machine with a card:
``python -m pytest tests/test_torch_bf16_cuda.py -m cuda -q``.

Bars: a bf16 output (p2, max, min, q3, mq) within one bf16 ulp of the
twin's on all but 1e-3 of its entries (where a bf16 rounding or ReLU
decision upstream goes the other way between the two summation orders);
pool indices equal except at near-ties (the twin's value at the kernel's
index within one bf16 ulp of its best); f32 accumulators within 1e-3 of
their max-abs; two calls bit-identical. B8a splits each pooled cotangent
among its group's exact ties of the f32 z inside the kernel, so its
cotangent is zero on the near-tie pairs (a distinct z within 1e-5 of the
largest |z| of a group's max, or a max within that of zero), where two
summation orders may route differently. The stage, card vs CPU: pooled at
rtol = atol = 5e-2 and gradients at relative L2 < 0.15, cosine > 0.99
(the JAX package's bf16 bars, tests/test_covar_bn.py:38-39,
tests/test_sa_pair.py:109-135).
"""
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda
BF16 = torch.bfloat16


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


def _ulp(v):
    _, e = torch.frexp(v.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v), e - 8)


def _rows(k, t):
    a, b = k.float(), t.float()
    beyond = (a - b).abs() > _ulp(torch.maximum(a.abs(), b.abs()))
    assert int(beyond.sum()) <= 1e-3 * a.numel()


def _acc(k, t):
    assert float((k - t).abs().max()) <= 1e-3 * float(t.abs().max())


def _layers(rng, dev):
    out, cin = [], 4
    for w in (64, 64, 256):
        out.append([torch.tensor(a, dtype=torch.float32, device=dev) for a in
                    (rng.normal(size=(cin, w), scale=0.3),
                     rng.normal(size=(w,), scale=0.1),
                     1.0 + 0.3 * rng.normal(size=(w,)),
                     rng.normal(size=(w,), scale=0.1))])
        cin = w
    return out


@pytest.mark.parametrize("K,B,N", [(64, 2, 1024), (128, 2, 1024),
                                   (16, 2, 1024), (4, 2, 1024),
                                   (2, 2, 1024), (1, 2, 1024),
                                   (192, 2, 768), (64, 4, 96)])
def test_bf16_sweeps_match_twins(dev, rng, K, B, N):
    """K: one group in a tile (64), groups spanning tiles (128, 192),
    several groups per tile (16, 4, 2, 1); N = 96 puts tiles across two
    clouds of channel-major x (the unstaged x paths)."""
    from facl_tpu_torch.ops import sa_pair as SP
    (w1, b1, _, _), (w2, b2, _, _), (w3, b3, _, _) = _layers(rng, dev)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    vec = lambda n, s=1.0: t(s * rng.normal(size=(n,)))
    x3 = t(rng.normal(size=(B, 4, N))).to(BF16)
    R, P = B * N, B * N // K
    mul1, shift1, mul2, shift2 = vec(64, 2), vec(64), vec(64, 2), vec(64)

    def both(fn, *args):
        k, tw = fn(*args), getattr(SP, fn.__name__ + "_plain")(*args)
        assert all(torch.equal(a, b) for a, b in zip(k, fn(*args)))
        return k, tw

    k, tw = both(SP.sa_fwd_layer12_bf16, x3, w1, b1, mul1, shift1, w2, b2)
    assert k[0].dtype == BF16
    _rows(k[0], tw[0])
    _acc(k[1], tw[1])
    _acc(k[2], tw[2])
    p2 = tw[0]

    k, tw = both(SP.sa_fwd_gram_pool_bf16, p2, mul2, shift2, w3, b3, K)
    _acc(k[0], tw[0])
    _acc(k[1], tw[1])
    _rows(k[2], tw[2])
    _rows(k[3], tw[3])
    p3 = (SP._rb(SP._h2_bf16(p2, mul2, shift2) @ SP._rb(w3))
          + SP._rb(b3)).reshape(-1, K, 256)
    for ki, ti, best in ((k[4], tw[4], tw[2]), (k[5], tw[5], tw[3])):
        assert int(ki.min()) >= 0 and int(ki.max()) < K
        g, c = (ki != ti).nonzero(as_tuple=True)
        v, bv = p3[g, ki[g, c].long(), c], best[g, c].float()
        assert bool(((v - bv).abs() <= _ulp(bv.abs())).all())

    u = rng.random(size=(P, 256))
    idx = np.where(u < 0.6, 0, np.where(u < 0.7, K,
                                        rng.integers(0, K, size=(P, 256))))
    idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    dp = vec(P * 256).view(P, 256).to(BF16)
    k, tw = both(SP.sa_bwd_sweep1_bf16, p2, mul2, shift2, dp, idx, vec(256),
                 w3, K)
    _acc(k[0], tw[0])
    _acc(k[1], tw[1])
    _rows(k[2], tw[2])

    q3 = vec(R * 64, 0.1).view(R, 64).to(BF16)
    M3, rc3, gi2 = t(0.01 * rng.normal(size=(64, 64))), vec(64, 0.1), vec(64)
    k, tw = both(SP.sa_bwd_sweep2_bf16, x3, w1, b1, mul1, shift1, p2, mul2,
                 shift2, q3, M3, rc3, gi2, w2)
    for a, b in zip(k[:4], tw[:4]):
        _acc(a, b)
    _rows(k[4], tw[4])

    mq = vec(R * 64, 0.1).view(R, 64).to(BF16)
    k, tw = both(SP.sa_bwd_sweep3_bf16, x3, w1, b1, mul1, shift1, mq,
                 t(0.01 * rng.normal(size=(64, 64))), vec(64, 0.1))
    _acc(k[0], tw[0])
    _acc(k[1], tw[1])


def _near_ties(z, pool: int, tol: float):
    """(P, C3): a group's largest z within tol of zero, or a distinct
    relu(z) within tol below a positive max (chip_smoke.py::near_ties)."""
    zg = z.reshape(-1, pool, z.shape[1])
    zmax = zg.amax(1, keepdim=True)
    gap = zmax - zg
    return (zmax[:, 0].abs() <= tol) | \
        ((zmax[:, 0] > 0) & ((gap > 0) & (gap <= tol)).any(1))


@pytest.mark.parametrize("K,B,N", [(64, 2, 1024), (128, 2, 1024),
                                   (16, 2, 1024), (4, 2, 1024),
                                   (2, 2, 1024), (1, 2, 1024),
                                   (192, 2, 768), (64, 4, 96)])
def test_bf16_two_sweep_kernels_match_twins(dev, rng, K, B, N):
    """B7a (x -> p1, p1 -> p2), B7b, B7c, B8a, B8b and B6 at bf16 against
    their bf16 twins, each fed the twin chain's own outputs. K as above;
    N = 96 puts B6's tiles across two clouds of channel-major x."""
    from facl_tpu_torch.ops import sa_bwd as SB
    from facl_tpu_torch.ops import sa_fwd as SF
    from facl_tpu_torch.ops import sa_pair as SP
    (w1, b1, _, _), (w2, b2, _, _), (w3, b3, _, _) = _layers(rng, dev)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    vec = lambda n, s=1.0: t(s * rng.normal(size=(n,)))
    x3 = t(rng.normal(size=(B, 4, N))).to(BF16)
    xr = x3.transpose(1, 2).reshape(-1, 4).contiguous()
    R, P = B * N, B * N // K
    mul1, shift1, mul2, shift2 = vec(64, 2), vec(64), vec(64, 2), vec(64)
    mul3, shift3, gi2, gi3 = vec(256, 0.2), vec(256), vec(64), vec(256)

    def both(fn, *args):
        """The kernel's and the twin's outputs; two kernel calls equal."""
        plain = getattr(sys.modules[fn.__module__], fn.__name__ + "_plain")
        k, tw, again = fn(*args), plain(*args), fn(*args)
        if isinstance(k, dict):
            assert all(torch.equal(k[n], again[n]) for n in k)
        elif isinstance(k, torch.Tensor):
            assert torch.equal(k, again)
        else:
            assert all(torch.equal(a, b) for a, b in zip(k, again))
        return k, tw

    k, tw = both(SF.sa_fwd_layer_bf16, xr, w1, b1)
    assert k[0].dtype == BF16
    _rows(k[0], tw[0])
    _acc(k[1], tw[1])
    _acc(k[2], tw[2])
    p1 = tw[0]
    k, tw = both(SF.sa_fwd_layer_bf16, p1, w2, b2, mul1, shift1)
    _rows(k[0], tw[0])
    _acc(k[1], tw[1])
    _acc(k[2], tw[2])
    p2 = tw[0]
    k, tw = both(SF.sa_fwd_gram_bf16, p2, mul2, shift2)
    _acc(k[0], tw[0])
    _acc(k[1], tw[1])
    k, tw = both(SF.sa_fwd_pool_bf16, p2, mul2, shift2, w3, b3, mul3, shift3,
                 K)
    assert k.dtype == BF16 and k.shape == (P, 256)
    _rows(k, tw)

    z = SB._z_bf16(SB._h_bf16(p2, mul2, shift2), w3, b3, mul3, shift3)
    near = _near_ties(z, K, 1e-5 * float(z.abs().max()))
    dp = torch.where(near, 0.0, vec(P * 256).view(P, 256)).to(BF16)
    k, tw = both(SB.sa_bwd2_sweep1_bf16, p2, mul2, shift2, w3, b3, mul3,
                 shift3, gi3, dp, K)
    for a, b in zip(k[:4], tw[:4]):
        _acc(a, b)
    assert k[4].dtype == BF16
    _rows(k[4], tw[4])
    q3 = tw[4]

    M3, rc3 = t(0.01 * rng.normal(size=(64, 64))), vec(64, 0.1)
    k, tw = both(SB.sa_bwd2_sweep2_bf16, xr, p1, mul1, shift1, p2, mul2,
                 shift2, q3, M3, rc3, gi2, w2)
    assert torch.equal(k["cnt1"], tw["cnt1"])
    for n in tw:
        _acc(k[n], tw[n])
    k, tw = both(SP.sa_bwd_sweep2_full_bf16, x3, w1, b1, mul1, shift1, p2,
                 mul2, shift2, q3, M3, rc3, gi2, w2)
    # B6's h1, recomputed from x, gives the bf16 forward chain's layer-1
    # masks (_h1_bf16), channel by channel.
    assert torch.equal(k["cnt1"], tw["cnt1"])
    for n in tw:
        _acc(k[n], tw[n])


@pytest.mark.parametrize("K", [16, 64, 128])
def test_bf16_b8a_duplicated_rows_match_twins(dev, rng, K):
    """B8a at bf16 on groups padded with copies of their first row, as
    ball query pads them (the last half of each group; at K = 128 in the
    group's second tile): exact ties of z split evenly by the kernel as by
    the twin. Accumulators within 1e-3 of their max-abs, q3 within one
    bf16 ulp but at most 1e-3 of its entries, dpooled zero on near-tie
    pairs; two calls bit-identical."""
    from facl_tpu_torch.ops import sa_bwd as SB
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    vec = lambda n, s=1.0: t(s * rng.normal(size=(n,)))
    R = 64 * K
    d = K - K // 2
    base = rng.normal(size=(R // K, K, 64)).astype(np.float32)
    base[:, 0] *= 3.0
    base[:, d:] = base[:, :1]
    p2 = t(base.reshape(R, 64)).to(BF16)
    (_, _, _, _), (_, _, _, _), (w3, b3, _, _) = _layers(rng, dev)
    mul2, shift2, mul3, shift3 = vec(64, 2), vec(64), vec(256, 0.2), \
        vec(256)
    gi3 = vec(256)
    z = SB._z_bf16(SB._h_bf16(p2, mul2, shift2), w3, b3, mul3, shift3)
    near = _near_ties(z, K, 1e-5 * float(z.abs().max()))
    dp = torch.where(near, 0.0, vec(R // K * 256).view(R // K, 256)).to(BF16)
    dy3 = SB._dy_top(z, dp.float(), K)
    routed = int((dp.float().abs() > 0).logical_and(
        (dy3.view(-1, K, 256) != 0).any(1)).sum())
    assert int((dy3 != 0).sum()) >= 3 * routed     # ties a routed pair
    args = (p2, mul2, shift2, w3, b3, mul3, shift3, gi3, dp, K)
    k, tw = SB.sa_bwd2_sweep1_bf16(*args), SB.sa_bwd2_sweep1_bf16_plain(*args)
    assert all(torch.equal(a, b) for a, b in
               zip(k, SB.sa_bwd2_sweep1_bf16(*args)))
    for a, b in zip(k[:4], tw[:4]):
        _acc(a, b)
    assert k[4].dtype == BF16
    _rows(k[4], tw[4])


@pytest.mark.parametrize("K", [64, 128])
@pytest.mark.parametrize("impl", ["pair", "hybrid2", "hybrid"])
def test_bf16_two_sweep_stages_card_vs_cpu(dev, rng, impl, K):
    """The bf16 stage of pair, hybrid2 and hybrid, card (bf16 kernels) vs
    CPU (bf16 twins), at the JAX package's bf16 bars (module
    docstring)."""
    from facl_tpu_torch.ops.fused_sa import SALayerParams
    from facl_tpu_torch.ops.sa_bwd import sa_train_hybrid
    from facl_tpu_torch.ops.sa_fwd import sa_train_pfwd
    from facl_tpu_torch.ops.sa_pair import sa_train_pair
    x = rng.normal(size=(4, 4, 16, K)).astype(np.float32)
    layers = [[a.cpu().numpy() for a in layer]
              for layer in _layers(rng, "cpu")]
    wvec = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    out = {}
    for d in ("cpu", dev):
        lp = [SALayerParams(*(torch.tensor(a, dtype=torch.float32,
                                           device=d, requires_grad=True)
                              for a in layer)) for layer in layers]
        xt = torch.from_numpy(x).to(d)
        if impl == "pair":
            pooled, _ = sa_train_pair(xt, lp, dtype=BF16)
        else:
            fn = sa_train_pfwd if impl == "hybrid2" else sa_train_hybrid
            pooled, _ = fn(xt.permute(0, 2, 3, 1), lp, dtype=BF16)
        assert pooled.dtype == BF16
        (torch.sin(pooled.float()) * wvec.to(d)).sum().backward()
        out[str(d)] = (pooled.detach().float().cpu(),
                       [t.grad.cpu() for layer in lp for t in layer])
    (pc, gc), (pg, gg) = out["cpu"], out[str(dev)]
    torch.testing.assert_close(pg, pc, rtol=5e-2, atol=5e-2)
    for i, (a, b) in enumerate(zip(gg, gc)):
        if i % 4 == 1:     # Dense bias before BN: exact gradient is zero
            continue
        a, b = a.double().flatten(), b.double().flatten()
        assert float((a - b).norm() / b.norm()) < 0.15
        assert float(a @ b / (a.norm() * b.norm())) > 0.99


def _b2b_b3b_inputs(rng, dev, B, N, K):
    from facl_tpu_torch.ops import sa_pair as SP
    (w1, b1, _, _), (w2, b2, _, _), (w3, b3, _, _) = _layers(rng, dev)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    vec = lambda n, s=1.0: t(s * rng.normal(size=(n,)))
    R = B * N
    x3 = t(rng.normal(size=(B, 4, N))).to(BF16)
    mul1, shift1, mul2, shift2 = vec(64, 2), vec(64), vec(64, 2), vec(64)
    p2 = SP.sa_fwd_layer12_bf16_plain(x3, w1, b1, mul1, shift1, w2, b2)[0]
    agp = (p2, mul2, shift2, w3, b3, K)
    q3 = vec(R * 64, 0.1).view(R, 64).to(BF16)
    as2 = (x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3,
           t(0.01 * rng.normal(size=(64, 64))), vec(64, 0.1), vec(64), w2)
    return agp, as2


def _b2b_b3b_match(agp, as2):
    """B2b-bf16 and B3b-bf16 against their twins at the module's bars,
    two calls of each bit-identical."""
    from facl_tpu_torch.ops import sa_pair as SP
    k = SP.sa_fwd_gram_pool_bf16(*agp)
    assert all(torch.equal(a, b)
               for a, b in zip(k, SP.sa_fwd_gram_pool_bf16(*agp)))
    tw = SP.sa_fwd_gram_pool_bf16_plain(*agp)
    _acc(k[0], tw[0])
    _acc(k[1], tw[1])
    _rows(k[2], tw[2])
    _rows(k[3], tw[3])
    K, P = agp[5], agp[0].shape[0] // agp[5]
    p3 = (SP._rb(SP._h2_bf16(*agp[:3]) @ SP._rb(agp[3]))
          + SP._rb(agp[4])).reshape(P, K, 256)
    for ki, ti, best in ((k[4], tw[4], tw[2]), (k[5], tw[5], tw[3])):
        assert int(ki.min()) >= 0 and int(ki.max()) < K
        g, c = (ki != ti).nonzero(as_tuple=True)
        v, bv = p3[g, ki[g, c].long(), c], best[g, c].float()
        assert bool(((v - bv).abs() <= _ulp(bv.abs())).all())
    k = SP.sa_bwd_sweep2_bf16(*as2)
    assert all(torch.equal(a, b)
               for a, b in zip(k, SP.sa_bwd_sweep2_bf16(*as2)))
    tw = SP.sa_bwd_sweep2_bf16_plain(*as2)
    for a, b in zip(k[:4], tw[:4]):
        _acc(a, b)
    assert k[4].dtype == BF16
    _rows(k[4], tw[4])


@pytest.mark.parametrize("K,B,N", [(128, 2, 8320), (64, 1, 64 * 397),
                                   (64, 3, 4160), (64, 16, 12)])
def test_bf16_b2b_b3b_redesigned(dev, rng, K, B, N):
    """The bf16 forms of B2b and B3b, kernels of their own (bf16 operands,
    mma.sync m16n8k16): K = 128 (pool groups spanning two 64-row tiles);
    row counts that the persistent blocks share unevenly (397 tiles: some
    blocks take one tile more, B3b's last 128-row step holds one tile;
    195 tiles: 34 of B3b's blocks take none); N = 12 (x rows not in 16-byte
    chunks: B3b reads them one by one)."""
    _b2b_b3b_match(*_b2b_b3b_inputs(rng, dev, B, N, K))


@pytest.mark.parametrize("K,B,N", [(128, 2, 8320), (64, 1, 64 * 397),
                                   (64, 3, 4160), (64, 16, 12),
                                   (8, 8, 24), (192, 2, 768)])
def test_bf16_b3a_b3c_redesigned(dev, rng, K, B, N):
    """The bf16 forms of B3a and B3c, kernels of their own (B3a: D
    scattered into a shared tile, wgmma; B3c: a warp a 16-row step,
    mma.sync m16n8k16): K = 128 and 192 (pool groups spanning two and
    three 64-row tiles); row counts the persistent blocks and warps share
    unevenly (397 tiles; 195); N = 12 and 24 (x rows not in whole 16-row
    steps of one cloud: B3c reads 8-row chunks, or rows one by one); K = 8
    (eight groups a tile). B3a's argmax layout skewed as the main path's
    (47% of a group's channels on its first row, 37% dead)."""
    from facl_tpu_torch.ops import sa_pair as SP
    (w1, b1, _, _), _, (w3, _, _, _) = _layers(rng, dev)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    vec = lambda n, s=1.0: t(s * rng.normal(size=(n,)))
    R, P = B * N, B * N // K
    u = rng.random(size=(P, 256))
    idx = np.where(u < 0.47, 0, np.where(u < 0.84, K,
                                         rng.integers(0, K, size=(P, 256))))
    as1 = (vec(R * 64).view(R, 64).to(BF16), vec(64, 0.3), vec(64),
           vec(P * 256).view(P, 256).to(BF16),
           torch.from_numpy(idx.astype(np.int32)).to(dev), vec(256), w3, K)
    k = SP.sa_bwd_sweep1_bf16(*as1)
    assert all(torch.equal(a, b)
               for a, b in zip(k, SP.sa_bwd_sweep1_bf16(*as1)))
    tw = SP.sa_bwd_sweep1_bf16_plain(*as1)
    _acc(k[0], tw[0])
    _acc(k[1], tw[1])
    assert k[2].dtype == BF16
    _rows(k[2], tw[2])
    as3 = (t(rng.normal(size=(B, 4, N))).to(BF16), w1, b1, vec(64, 2),
           vec(64), vec(R * 64, 0.1).view(R, 64).to(BF16),
           t(0.01 * rng.normal(size=(64, 64))), vec(64, 0.1))
    k = SP.sa_bwd_sweep3_bf16(*as3)
    assert all(torch.equal(a, b)
               for a, b in zip(k, SP.sa_bwd_sweep3_bf16(*as3)))
    tw = SP.sa_bwd_sweep3_bf16_plain(*as3)
    _acc(k[0], tw[0])
    _acc(k[1], tw[1])


@pytest.mark.parametrize("C0,B,N", [(4, 2, 32 * 128), (4, 16, 12),
                                    (3, 16, 12), (4, 8, 40), (3, 8, 40),
                                    (4, 4, 96), (4, 1, 192), (7, 1, 192)])
def test_bf16_b2a_redesigned(dev, rng, C0, B, N):
    """The bf16 form of B2a, a kernel of its own (h1 made as the A
    fragments of mma.sync m16n8k16, p2 staged by stmatrix): N = 32 x 128
    (the fine variant's S = 32, K = 128); N = 12 (x rows not in 8-row
    pieces of one cloud: the warp reads them one by one); N = 40 and 96
    (32-row steps across clouds: 8-row pieces of two clouds); C0 = 3, 4
    and 7 (both instantiations); B = 1, N = 192: six steps for far fewer
    than the grid's warps (most take none)."""
    from facl_tpu_torch.ops import sa_pair as SP
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    x3 = t(rng.normal(size=(B, C0, N))).to(BF16)
    a12 = (x3, t(rng.normal(size=(C0, 64), scale=0.3)),
           t(rng.normal(size=(64,), scale=0.1)),
           t(2.0 * rng.normal(size=(64,))), t(rng.normal(size=(64,))),
           t(rng.normal(size=(64, 64), scale=0.3)),
           t(rng.normal(size=(64,), scale=0.1)))
    k = SP.sa_fwd_layer12_bf16(*a12)
    assert all(torch.equal(a, b)
               for a, b in zip(k, SP.sa_fwd_layer12_bf16(*a12)))
    tw = SP.sa_fwd_layer12_bf16_plain(*a12)
    assert k[0].dtype == BF16
    _rows(k[0], tw[0])
    _acc(k[1], tw[1])
    _acc(k[2], tw[2])


def test_bf16_b2b_b3b_misaligned(dev, rng):
    """Row tensors staged by 16-byte copies (p2, q3) raise when they are
    not 16-byte aligned; an unaligned x is read row by row and matches."""
    from facl_tpu_torch.ops import sa_pair as SP
    agp, as2 = _b2b_b3b_inputs(rng, dev, 2, 1024, 64)

    def shifted(a):          # the same values, 2 bytes off alignment
        flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
        out = flat[1:].view(a.shape)
        out.copy_(a)
        return out
    with pytest.raises(ValueError, match="16-byte"):
        SP.sa_fwd_gram_pool_bf16(shifted(agp[0]), *agp[1:])
    with pytest.raises(ValueError, match="16-byte"):
        SP.sa_bwd_sweep2_bf16(*as2[:5], shifted(as2[5]), *as2[6:])
    with pytest.raises(ValueError, match="16-byte"):
        SP.sa_bwd_sweep2_bf16(*as2[:8], shifted(as2[8]), *as2[9:])
    x3 = shifted(as2[0])
    assert x3.data_ptr() % 16
    _b2b_b3b_match(agp, (x3,) + as2[1:])


def test_bf16_sweeps_take_bf16_rows_only(dev):
    """The storage dtype is checked: f32 rows into a bf16 sweep, or bf16
    rows into an f32 one, raise ValueError before a launch."""
    from facl_tpu_torch.ops import sa_pair as SP
    v = torch.ones(64, device=dev)
    w1, w2 = torch.zeros(4, 64, device=dev), torch.zeros(64, 64, device=dev)
    x3 = torch.zeros(1, 4, 256, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        SP.sa_fwd_layer12_bf16(x3, w1, v, v, v, w2, v)
    with pytest.raises(ValueError, match="float32"):
        SP.sa_fwd_layer12(x3.to(BF16), w1, v, v, v, w2, v)
    with pytest.raises(ValueError, match="bfloat16"):
        SP.sa_bwd_sweep3_bf16(x3.to(BF16), w1, v, v, v,
                              torch.zeros(256, 64, device=dev), w2, v)


@pytest.mark.parametrize("K", [64, 128])
def test_bf16_pair3_stage_card_vs_cpu(dev, rng, K):
    from facl_tpu_torch.ops.fused_sa import SALayerParams
    from facl_tpu_torch.ops.sa_pair import sa_train_pair3
    x = rng.normal(size=(4, 4, 16, K)).astype(np.float32)
    layers = [[a.cpu().numpy() for a in layer]
              for layer in _layers(rng, "cpu")]
    wvec = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    out = {}
    for d in ("cpu", dev):
        lp = [SALayerParams(*(torch.tensor(a, dtype=torch.float32,
                                           device=d, requires_grad=True)
                              for a in layer)) for layer in layers]
        pooled, _ = sa_train_pair3(torch.from_numpy(x).to(d), lp,
                                   dtype=BF16)
        assert pooled.dtype == BF16
        (torch.sin(pooled.float()) * wvec.to(d)).sum().backward()
        out[str(d)] = (pooled.detach().float().cpu(),
                       [t.grad.cpu() for layer in lp for t in layer])
    (pc, gc), (pg, gg) = out["cpu"], out[str(dev)]
    torch.testing.assert_close(pg, pc, rtol=5e-2, atol=5e-2)
    for i, (a, b) in enumerate(zip(gg, gc)):
        if i % 4 == 1:     # Dense bias before BN: exact gradient is zero
            continue
        a, b = a.double().flatten(), b.double().flatten()
        assert float((a - b).norm() / b.norm()) < 0.15
        assert float(a @ b / (a.norm() * b.norm())) > 0.99


def _b9_layers(rng, widths, dev):
    out, cin = [], 4
    for w in widths:
        out.append([torch.tensor(a, dtype=torch.float32, device=dev) for a in
                    (rng.normal(size=(cin, w), scale=0.5),
                     rng.normal(size=(w,), scale=0.1),
                     1.0 + 0.1 * rng.normal(size=(w,)),
                     rng.normal(size=(w,), scale=0.1))])
        cin = w
    return out


@pytest.mark.parametrize("K,widths", [(64, (64, 64, 256)),
                                      (128, (64, 64, 256)),
                                      (8, (8, 16, 32)), (48, (32,))])
def test_b9_bf16_sweeps_match_twins(dev, rng, K, widths):
    """B9's eight sweeps at bf16 against their bf16 twins on the same card
    tensors, each fed the twin's inputs: stats, BN sums and dW within 1e-3
    of their max-abs; pooled within one bf16 ulp but at 1e-3 of its
    entries; dx at rtol 1e-5 / atol 1e-5 x scale but at 1e-3 of its rows
    (rows whose bf16 rounding went the other way upstream); db near zero;
    two calls bit-identical. The bf16 cotangent is zero on the bf16 near-
    tie pairs of the twin's top layer: a distinct bf16 value within one
    ulp below a group's max, or a max within one ulp of zero."""
    _b9_bf16_vs_twins(dev, rng, K, widths)


def _b9_bf16_vs_twins(dev, rng, K, widths, dx_rows=1e-3):
    """test_b9_bf16_sweeps_match_twins's checks, dx held at ``dx_rows`` of
    its rows."""
    from facl_tpu_torch.ops import sa_kernel as SK
    from facl_tpu_torch.ops.fused_sa import SALayerParams
    R = 64 * K
    x = torch.from_numpy(rng.normal(size=(R, 4)).astype(np.float32)).to(dev)
    lp = [SALayerParams(*layer) for layer in _b9_layers(rng, widths, dev)]
    packed = torch.zeros(len(widths), 2, max(widths), device=dev)
    for l, w in enumerate(widths):
        a = (x, lp, packed.clone(), K, l)
        k = SK.sa_fused_stats_bf16(*a)
        for u, t in zip(k, SK.sa_fused_stats_bf16_plain(*a)):
            _acc(u, t)
        assert all(torch.equal(u, t) for u, t in
                   zip(k, SK.sa_fused_stats_bf16(*a)))
        s, ss = SK.sa_fused_stats_bf16_plain(*a)
        mean = s / R
        var = (ss / R - mean * mean).clamp_min(0.0)
        packed[l, 0, :w], packed[l, 1, :w] = mean, torch.rsqrt(var + 1e-5)
    a = (x, lp, packed, K)
    pooled = SK.sa_fused_pool_bf16(*a)
    assert torch.equal(pooled, pooled.to(BF16).float())
    assert torch.equal(pooled, SK.sa_fused_pool_bf16(*a))
    _rows(pooled, SK.sa_fused_pool_bf16_plain(*a))

    v = SK.vectors(lp, packed, None, R, True)
    hs = SK._forward_plain(x, lp, v, len(lp) - 1, True)[1]
    wt = widths[-1]
    z = SK._rb((SK._rb(hs[-1] @ SK._rb(lp[-1].kernel)) + v[-1, 0, :wt])
               * v[-1, 3, :wt] + v[-1, 4, :wt]).reshape(-1, K, wt)
    h = torch.relu(z)
    m = h.amax(1, keepdim=True)
    u = _ulp(m)
    near = (((m - h) > 0) & ((m - h) <= u)).any(1) | \
        ((m[:, 0] == 0) & (z > -u).any(1)) | \
        ((m[:, 0] > 0) & (m[:, 0] <= u[:, 0]))
    dout = torch.from_numpy(rng.normal(size=(R // K, wt)).astype(np.float32)
                            ).to(dev).to(BF16).float()
    dout = torch.where(near, 0.0, dout)
    bsums = torch.zeros_like(packed)
    for l in reversed(range(len(widths))):
        a = (x, lp, packed, bsums.clone(), dout, K, l)
        k = SK.sa_fused_bnsum_bf16(*a)
        t = SK.sa_fused_bnsum_bf16_plain(*a)
        for u_, t_ in zip(k, t):
            _acc(u_, t_)
        assert all(torch.equal(u_, t_) for u_, t_ in
                   zip(k, SK.sa_fused_bnsum_bf16(*a)))
        bsums[l, 0, :widths[l]], bsums[l, 1, :widths[l]] = t
    a = (x, lp, packed, bsums, dout, K)
    kd, kw, kb = SK.sa_fused_final_bf16(*a)
    td, tw, tb = SK.sa_fused_final_bf16_plain(*a)
    beyond = ((kd - td).abs() > 1e-5 * td.abs()
              + 1e-5 * float(td.abs().max())).any(1)
    assert int(beyond.sum()) <= dx_rows * R
    for u_, t_ in zip(kw, tw):
        _acc(u_, t_)
    gscale = max(float(t_.abs().max()) for t_ in tw)
    for u_, t_ in zip(kb, tb):
        assert max(float(u_.abs().max()), float(t_.abs().max())) < \
            1e-4 * gscale
    k2 = SK.sa_fused_final_bf16(*a)
    assert torch.equal(k2[0], kd) and all(
        torch.equal(u_, t_) for u_, t_ in zip(k2[1] + k2[2], kw + kb))
    assert SK.sa_fused_final_bf16(*a, False)[0] is None


def test_b9_bf16_final_sweep_in_rounds_matches_twins(dev, rng):
    """A net whose dW has more 16 x 16 units than the bf16 kernel's warps
    hold in registers (widths (128, 256): 136 units, 96 a round) runs its
    final sweep in two rounds over the tiles: held as the other nets."""
    units = sum(-(-cin // 16) * -(-w // 16)
                for cin, w in ((4, 128), (128, 256)))
    assert units > 96
    test_b9_bf16_sweeps_match_twins(dev, rng, 64, (128, 256))


@pytest.mark.parametrize("widths,tensor_cores,smem", [
    ((64, 112, 256), True, 220928), ((64, 128, 256), False, 172032),
    ((128, 128, 256), False, 188416)])
def test_b9_bf16_wider_nets_match_twins(dev, rng, widths, tensor_cores,
                                        smem):
    """Nets wider than the main path's at pool 64, held as the others: the
    tensor-core kernel at 64-row tiles where its layout fits, else the
    CUDA-core kernel's bf16 instantiation (the tensor-core layout would
    need 245,760 and 281,600 B there), so every net that the CUDA-core
    kernel holds still runs. ``smem``: the bytes of the kernel that runs.
    dx at 5e-3 of its rows: a 112- or 128-wide layer rounds more dp
    values to bf16 a row, each of which may go the other way between two
    orders of f32 sums (on the card, H100: 5, 5 and 8 rows of 4,096, the
    two CUDA-core nets summing in k order as the kernel before the tensor
    cores did)."""
    import ctypes
    from facl_tpu_torch.ops import _build
    from facl_tpu_torch.ops import sa_kernel as SK
    R = 64 * 64
    assert SK.bf16_on_tensor_cores(R, 4, list(widths), 64) == tensor_cores
    fn = _build.REGISTRY.get("sa_fused").facl_sa_fused_bf16_smem
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    assert fn(R, 4, len(widths), ctypes.cast(SK._widths_arg(list(widths)),
                                             ctypes.c_void_p), 64) == smem
    _b9_bf16_vs_twins(dev, rng, 64, widths, dx_rows=5e-3)


@pytest.mark.parametrize("K", [64, 128])
def test_bf16_pallas_stage_card_vs_cpu(dev, rng, K):
    """sa_train_fused at bf16 (B9's bf16 sweeps on the card, their twins on
    the CPU) on the same rows and weights: pooled at rtol = atol = 5e-2,
    the gradients of x and of every parameter at relative L2 < 0.15 and
    cosine > 0.99."""
    from facl_tpu_torch.ops.fused_sa import SALayerParams, sa_train_fused
    x = rng.normal(size=(4 * 16 * K, 4)).astype(np.float32)
    layers = [[a.cpu().numpy() for a in layer]
              for layer in _layers(rng, "cpu")]
    wvec = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    out = {}
    for d in ("cpu", dev):
        lp = [SALayerParams(*(torch.tensor(a, dtype=torch.float32,
                                           device=d, requires_grad=True)
                              for a in layer)) for layer in layers]
        xt = torch.from_numpy(x).to(d).requires_grad_(True)
        pooled, _ = sa_train_fused(xt, lp, K, compute_dtype=BF16)
        (torch.sin(pooled.to(BF16).float()) * wvec.to(d)).sum().backward()
        out[str(d)] = (pooled.detach().cpu(), [xt.grad.cpu()] +
                       [t.grad.cpu() for layer in lp for t in layer])
    (pc, gc), (pg, gg) = out["cpu"], out[str(dev)]
    torch.testing.assert_close(pg, pc, rtol=5e-2, atol=5e-2)
    for i, (a, b) in enumerate(zip(gg, gc)):
        if i % 4 == 2:     # Dense bias before BN: exact gradient is zero
            continue
        a, b = a.double().flatten(), b.double().flatten()
        assert float((a - b).norm() / b.norm()) < 0.15
        assert float(a @ b / (a.norm() * b.norm())) > 0.99
