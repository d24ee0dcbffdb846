"""CUDA kernels of the port against their plain twins, on the card.

Marked ``cuda``: each test skips (with its reason) where no card is
present; ``chip_smoke.py`` holds the same kernels to the same bars at the
main path's full shapes. On a machine with a card:
``python -m pytest tests/test_torch_cuda.py -m cuda -q``.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def test_select_gather_bit_equal(dev, rng):
    from facl_tpu_torch.ops.select import select_gather, select_gather_plain
    pts = torch.from_numpy(
        rng.uniform(-0.5, 0.5, size=(8, 512, 4)).astype(np.float32)).to(dev)
    g, i = select_gather(pts, 64, 64, 0.06, return_idx=True)
    gp, ip = select_gather_plain(pts, 64, 64, 0.06)
    assert torch.equal(i, ip) and torch.equal(g, gp)


def _layers(rng, d="cpu"):
    from facl_tpu_torch.ops.fused_sa import SALayerParams
    out, cin = [], 4
    for w in (64, 64, 256):
        out.append([rng.normal(size=(cin, w), scale=0.3),
                    rng.normal(size=(w,), scale=0.1),
                    1.0 + 0.3 * rng.normal(size=(w,)),
                    rng.normal(size=(w,), scale=0.1)])
        cin = w
    return out


def _stage_vs_twins(dev, rng, K, train):
    """train(x_cf or x, layers) on the CPU (twins) and on the card
    (kernels), same inputs; pooled at the bar of tests/test_sa_pair.py,
    gradients at 2e-4 of their scale (tests/test_torch_parity.py)."""
    from facl_tpu_torch.ops.fused_sa import SALayerParams
    x = rng.normal(size=(4, 4, 16, K)).astype(np.float32)
    layers = _layers(rng)
    wvec = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    out = {}
    for d in ("cpu", dev):
        lp = [SALayerParams(*(torch.tensor(a, dtype=torch.float32,
                                           device=d, requires_grad=True)
                              for a in layer)) for layer in layers]
        pooled, _ = train(torch.from_numpy(x).to(d), lp)
        (torch.sin(pooled) * wvec.to(d)).sum().backward()
        out[str(d)] = (pooled.detach().cpu(),
                       [t.grad.cpu() for layer in lp for t in layer])
    (pc, gc), (pg, gg) = out["cpu"], out[str(dev)]
    torch.testing.assert_close(pg, pc, rtol=1e-4, atol=1e-5)
    gscale = max(float(t.abs().max()) for t in gc)
    for i, (a, b) in enumerate(zip(gg, gc)):
        if i % 4 == 1:     # Dense bias before BN: exact gradient is zero
            assert float(a.abs().max()) < 1e-4 * gscale
            continue
        scale = max(float(b.abs().max()), 1e-8)
        torch.testing.assert_close(a / scale, b / scale, rtol=0, atol=2e-4)


@pytest.mark.parametrize("K", [64, 128])   # a pool group in one / two tiles
def test_pair3_stage_matches_twins(dev, rng, K):
    from facl_tpu_torch.ops.sa_pair import sa_train_pair3
    _stage_vs_twins(dev, rng, K, sa_train_pair3)


@pytest.mark.parametrize("K", [64, 128])
@pytest.mark.parametrize("impl", ["pair", "hybrid2", "hybrid"])
def test_two_sweep_stages_match_twins(dev, rng, impl, K):
    from facl_tpu_torch.ops.sa_bwd import sa_train_hybrid
    from facl_tpu_torch.ops.sa_fwd import sa_train_pfwd
    from facl_tpu_torch.ops.sa_pair import sa_train_pair
    if impl == "pair":
        _stage_vs_twins(dev, rng, K, sa_train_pair)
        return
    fn = sa_train_pfwd if impl == "hybrid2" else sa_train_hybrid
    _stage_vs_twins(dev, rng, K,
                    lambda x, lp: fn(x.permute(0, 2, 3, 1), lp))


@pytest.mark.parametrize("K", [64, 128, 16, 4, 2, 1, 192])
def test_b6_b7_b8_kernels_match_twins(dev, rng, K):
    """Each new wrapper against its plain twin on the same card tensors:
    accumulators within 1e-4 of their max-abs, row outputs and pooled
    values at rtol 1e-5 / atol 1e-5 x scale, cnt1 exactly; two calls
    bit-identical. K: one group in a tile (64), groups spanning tiles
    (128, 192), several groups per tile (16, 4, 2, 1)."""
    from facl_tpu_torch.ops import sa_bwd as SB
    from facl_tpu_torch.ops import sa_fwd as SF
    from facl_tpu_torch.ops import sa_pair as SP

    def close(k, t, acc):
        if acc:
            assert float((k - t).abs().max()) <= 1e-4 * float(t.abs().max())
        else:
            torch.testing.assert_close(k, t, rtol=1e-5,
                                       atol=1e-5 * float(t.abs().max()))

    def both(fn, plain, *args, acc):
        k, t, again = fn(*args), plain(*args), fn(*args)
        if isinstance(k, dict):
            assert all(torch.equal(k[n], again[n]) for n in k)
        elif isinstance(k, torch.Tensor):
            assert torch.equal(k, again)
        else:
            assert all(torch.equal(a, b) for a, b in zip(k, again))
        if isinstance(k, dict):
            assert torch.equal(k["cnt1"], t["cnt1"])
            for n in t:
                close(k[n], t[n], True)
        else:
            for a, b, is_acc in zip(k, t, acc):
                close(a, b, is_acc)
        return t

    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    (w1, b1, _, _), (w2, b2, _, _), (w3, b3, _, _) = \
        [[t(a) for a in layer] for layer in _layers(rng)]
    R = 4 * 16 * K
    x = t(rng.normal(size=(R, 4)))
    vec = lambda n, s=1.0: t(s * rng.normal(size=(n,)))
    mul1, shift1, mul2, shift2 = vec(64, 2), vec(64), vec(64, 0.3), vec(64)
    mul3, shift3, gi2, gi3 = vec(256, 0.2), vec(256), vec(64), vec(256)
    p1, _, _ = both(SF.sa_fwd_layer, SF.sa_fwd_layer_plain, x, w1, b1,
                    acc=(False, True, True))
    p2, _, _ = both(SF.sa_fwd_layer, SF.sa_fwd_layer_plain, p1, w2, b2,
                    mul1, shift1, acc=(False, True, True))
    both(SF.sa_fwd_gram, SF.sa_fwd_gram_plain, p2, mul2, shift2,
         acc=(True, True))
    both(SF.sa_fwd_pool, SF.sa_fwd_pool_plain, p2, mul2, shift2, w3, b3,
         mul3, shift3, K, acc=(False,))
    dp = vec(R // K * 256).view(R // K, 256)
    q3 = both(SB.sa_bwd2_sweep1, SB.sa_bwd2_sweep1_plain, p2, mul2, shift2,
              w3, b3, mul3, shift3, gi3, dp, K,
              acc=(True, True, True, True, False))[-1]
    M3, rc3 = t(0.01 * rng.normal(size=(64, 64))), vec(64, 0.1)
    both(SB.sa_bwd2_sweep2, SB.sa_bwd2_sweep2_plain, x, p1, mul1, shift1,
         p2, mul2, shift2, q3, M3, rc3, gi2, w2, acc=None)
    x3 = x.view(4, 16 * K, 4).transpose(1, 2).contiguous()
    both(SP.sa_bwd_sweep2_full, SP.sa_bwd_sweep2_full_plain, x3, w1, b1,
         mul1, shift1, p2, mul2, shift2, q3, M3, rc3, gi2, w2, acc=None)


def padded_groups(rng, R: int, K: int, C: int = 64):
    """(R, C) rows laid out as ball query pads a group: in each group of K
    rows the last half repeat the group's first row (which is drawn at
    three times the scale, so that it is often the max), the rest
    distinct."""
    d = K - K // 2
    base = rng.normal(size=(R // K, K, C)).astype(np.float32)
    base[:, 0] *= 3.0
    base[:, d:] = base[:, :1]
    return base.reshape(R, C)


def near_tie_pairs(z, K: int):
    """chip_smoke.py::near_ties at its tolerance (1e-5 of max |z|)."""
    zg = z.reshape(-1, K, z.shape[1])
    tol = 1e-5 * float(z.abs().max())
    zmax = zg.amax(1, keepdim=True)
    gap = zmax - zg
    return (zmax[:, 0].abs() <= tol) | \
        ((zmax[:, 0] > 0) & ((gap > 0) & (gap <= tol)).any(1))


@pytest.mark.parametrize("K", [16, 64, 128])
def test_b8a_duplicated_rows_match_twins(dev, rng, K):
    """B8a on groups padded with copies of their first row (exact ties of
    z, split evenly by the kernel as by the twin; at K = 128 the copies
    lie in the group's second tile): accumulators within 1e-4 of their
    max-abs, q3 at rtol 1e-5 / atol 1e-5 x scale, dpooled zero on near-tie
    pairs; two calls bit-identical."""
    from facl_tpu_torch.ops import sa_bwd as SB
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    vec = lambda n, s=1.0: t(s * rng.normal(size=(n,)))
    R = 64 * K
    p2 = t(padded_groups(rng, R, K))
    w3, b3 = t(rng.normal(size=(64, 256), scale=0.3)), vec(256, 0.1)
    mul2, shift2, mul3, shift3 = vec(64, 0.3), vec(64), vec(256, 0.2), \
        vec(256)
    gi3 = vec(256)
    z = (SB._h_from_p(p2, mul2, shift2) @ w3 + b3) * mul3 + shift3
    dp = torch.where(near_tie_pairs(z, K), 0.0,
                     vec(R // K * 256).view(R // K, 256))
    dy3 = SB._dy_top(z, dp, K)
    routed = int((dp.abs() > 0).logical_and(
        (dy3.view(-1, K, 256) != 0).any(1)).sum())
    assert int((dy3 != 0).sum()) >= 3 * routed     # ties a routed pair
    args = (p2, mul2, shift2, w3, b3, mul3, shift3, gi3, dp, K)
    k, tw, again = SB.sa_bwd2_sweep1(*args), SB.sa_bwd2_sweep1_plain(*args), \
        SB.sa_bwd2_sweep1(*args)
    assert all(torch.equal(a, b) for a, b in zip(k, again))
    for a, b in zip(k[:4], tw[:4]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    torch.testing.assert_close(k[4], tw[4], rtol=1e-5,
                               atol=1e-5 * float(tw[4].abs().max()))


@pytest.mark.parametrize("K,B,N", [(64, 2, 1024), (128, 2, 1024),
                                   (16, 2, 1024), (4, 2, 1024),
                                   (192, 2, 768), (64, 4, 96)])
def test_b2b_b3b_kernels_match_twins(dev, rng, K, B, N):
    """The tensor-core sweeps B2b (sa_fwd_gram_pool) and B3b
    (sa_bwd_sweep2) against their twins on the same card tensors:
    accumulators within 1e-4 of their max-abs; pooled values and mq at
    rtol 1e-5 / atol 1e-5 x scale; pool indices equal except where the
    twin's own values tie (within 1e-5 x scale); two calls bit-identical.
    K: one group in a tile (64), groups spanning two or three tiles (128,
    192), several groups per tile (16, 4). N = 96 puts tiles across two
    clouds of channel-major x (the unstaged x path of B3b)."""
    from facl_tpu_torch.ops import sa_pair as SP
    from facl_tpu_torch.ops.sa_bwd import _h_from_p

    def acc(k, t):
        assert float((k - t).abs().max()) <= 1e-4 * float(t.abs().max())

    def row(k, t):
        torch.testing.assert_close(k, t, rtol=1e-5,
                                   atol=1e-5 * float(t.abs().max()))

    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    (w1, b1, _, _), (w2, b2, _, _), (w3, b3, _, _) = \
        [[t(a) for a in layer] for layer in _layers(rng)]
    x3 = t(rng.normal(size=(B, 4, N)))
    R = B * N
    vec = lambda n, s=1.0: t(s * rng.normal(size=(n,)))
    mul1, shift1, mul2, shift2 = vec(64, 2), vec(64), vec(64, 2), vec(64)
    p2 = SP.sa_fwd_layer12_plain(x3, w1, b1, mul1, shift1, w2, b2)[0]
    args = (p2, mul2, shift2, w3, b3, K)
    k, tw = SP.sa_fwd_gram_pool(*args), SP.sa_fwd_gram_pool_plain(*args)
    acc(k[0], tw[0])
    acc(k[1], tw[1])
    row(k[2], tw[2])
    row(k[3], tw[3])
    p3 = (_h_from_p(p2, mul2, shift2) @ w3 + b3).reshape(-1, K, 256)
    scale = float(p3.abs().max())
    for ki, ti, best in ((k[4], tw[4], tw[2]), (k[5], tw[5], tw[3])):
        assert int(ki.min()) >= 0 and int(ki.max()) < K
        g, c = (ki != ti).nonzero(as_tuple=True)
        v = p3[g, ki[g, c].long(), c]
        assert bool(((v - best[g, c]).abs() <= 1e-5 * scale).all())
    assert all(torch.equal(a, b) for a, b in
               zip(k, SP.sa_fwd_gram_pool(*args)))
    q3 = vec(R * 64, 0.1).view(R, 64)
    M3, rc3, gi2 = t(0.01 * rng.normal(size=(64, 64))), vec(64, 0.1), vec(64)
    args = (x3, w1, b1, mul1, shift1, p2, mul2, shift2, q3, M3, rc3, gi2, w2)
    k, tw = SP.sa_bwd_sweep2(*args), SP.sa_bwd_sweep2_plain(*args)
    for a, b in zip(k[:4], tw[:4]):
        acc(a, b)
    row(k[4], tw[4])
    assert all(torch.equal(a, b) for a, b in zip(k, SP.sa_bwd_sweep2(*args)))


def test_b2b_b3b_misaligned_rows_raise(dev, rng):
    """B2b and B3b stage rows by 16-byte TMA copies: a view 4 bytes past
    a 16-byte boundary raises ValueError; there is no fallback."""
    from facl_tpu_torch.ops import sa_pair as SP
    R = 256
    buf = torch.zeros(R * 64 + 1, device=dev)
    p2 = buf[1:].view(R, 64)
    v64 = torch.ones(64, device=dev)
    w3, b3 = torch.zeros(64, 256, device=dev), torch.zeros(256, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        SP.sa_fwd_gram_pool(p2, v64, v64, w3, b3, 64)
    x3 = torch.zeros(1, 4, R, device=dev)
    w = torch.zeros(64, 64, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        SP.sa_bwd_sweep2(x3, torch.zeros(4, 64, device=dev), v64, v64, v64,
                         p2, v64, v64, torch.zeros(R, 64, device=dev), w,
                         v64, v64, w)


@pytest.mark.parametrize("K,B,N", [(64, 2, 1024), (128, 2, 1024),
                                   (16, 2, 1024), (4, 2, 1024),
                                   (2, 2, 1024), (1, 2, 1024),
                                   (192, 2, 768), (64, 4, 96)])
def test_b3a_b3c_kernels_match_twins(dev, rng, K, B, N):
    """B3a (sa_bwd_sweep1: counting-sorted q3 rows, TMA-staged tiles) and
    B3c (sa_bwd_sweep3, tensor cores in 3xTF32) against their twins on the
    same card tensors: A3, u3, A1 and u1 within 1e-4 of their max-abs, q3
    at rtol 1e-5 / atol 1e-5 x scale, two calls bit-identical. The argmax
    rows are skewed as on random points (most channels on a group's first
    row) with dead ReLUs (idx == K) among them. K: one group in a tile
    (64), groups spanning tiles (128, 192), several groups per tile (16, 4,
    2, 1). N = 96 puts tiles across two clouds of channel-major x (the
    unstaged x path of B3c)."""
    from facl_tpu_torch.ops import sa_pair as SP

    def acc(k, t):
        assert float((k - t).abs().max()) <= 1e-4 * float(t.abs().max())

    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    (w1, b1, _, _), (w2, b2, _, _), (w3, _, _, _) = \
        [[t(a) for a in layer] for layer in _layers(rng)]
    x3 = t(rng.normal(size=(B, 4, N)))
    R, P = B * N, B * N // K
    vec = lambda n, s=1.0: t(s * rng.normal(size=(n,)))
    mul1, shift1, mul2, shift2 = vec(64, 2), vec(64), vec(64, 2), vec(64)
    p2 = SP.sa_fwd_layer12_plain(x3, w1, b1, mul1, shift1, w2, b2)[0]
    u = rng.random(size=(P, 256))
    idx = np.where(u < 0.6, 0, np.where(u < 0.7, K,
                                        rng.integers(0, K, size=(P, 256))))
    idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    args = (p2, mul2, shift2, vec(P * 256).view(P, 256), idx, vec(256),
            w3, K)
    k, tw = SP.sa_bwd_sweep1(*args), SP.sa_bwd_sweep1_plain(*args)
    acc(k[0], tw[0])
    acc(k[1], tw[1])
    torch.testing.assert_close(k[2], tw[2], rtol=1e-5,
                               atol=1e-5 * float(tw[2].abs().max()))
    assert all(torch.equal(a, b) for a, b in zip(k, SP.sa_bwd_sweep1(*args)))
    args = (x3, w1, b1, mul1, shift1, vec(R * 64, 0.1).view(R, 64),
            t(0.01 * rng.normal(size=(64, 64))), vec(64, 0.1))
    k, tw = SP.sa_bwd_sweep3(*args), SP.sa_bwd_sweep3_plain(*args)
    acc(k[0], tw[0])
    acc(k[1], tw[1])
    assert all(torch.equal(a, b) for a, b in zip(k, SP.sa_bwd_sweep3(*args)))


def test_b3a_b3c_bad_inputs_raise(dev):
    """B3a takes a mul2|shift2 vector of 2 x 64 float32 values and, like
    B3c, rows staged by 16-byte TMA copies: anything else raises
    ValueError before a launch; there is no fallback."""
    from facl_tpu_torch.ops import sa_pair as SP
    R, K = 256, 64
    v64 = torch.ones(64, device=dev)
    p2 = torch.zeros(R, 64, device=dev)
    dp = torch.zeros(R // K, 256, device=dev)
    idx = torch.zeros(R // K, 256, dtype=torch.int32, device=dev)
    g3, w3 = torch.ones(256, device=dev), torch.zeros(64, 256, device=dev)
    for mul2, shift2 in ((torch.ones(63, device=dev), v64),
                         (v64.double(), v64.double())):
        with pytest.raises(ValueError, match="mul2|shift2"):
            SP.sa_bwd_sweep1(p2, mul2, shift2, dp, idx, g3, w3, K)
    off = torch.zeros(R * 64 + 1, device=dev)[1:].view(R, 64)
    with pytest.raises(ValueError, match="aligned"):
        SP.sa_bwd_sweep1(off, v64, v64, dp, idx, g3, w3, K)
    x3 = torch.zeros(1, 4, R, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        SP.sa_bwd_sweep3(x3, torch.zeros(4, 64, device=dev), v64, v64, v64,
                         off, torch.zeros(64, 64, device=dev), v64)


@pytest.mark.parametrize("impl", ["pair", "pair3", "hybrid2", "hybrid"])
def test_sweep_impls_at_other_widths_raise(dev, impl):
    """The B2-B8 sweeps take SA widths TRUNK only: a stage of other widths
    that names one of their impls raises ValueError naming TRUNK before
    any launch; the same stage runs its twins on CPU tensors."""
    from facl_tpu_torch.models.sa_stage import SetAbstractionStage
    from facl_tpu_torch.ops import sa_bwd, sa_fwd, sa_pair
    st = SetAbstractionStage(4, (8, 8, 16), impl=impl).train()
    x = torch.randn(2, 4, 4, 8, generator=torch.Generator().manual_seed(0))
    assert st(x).shape == (2, 4, 16)
    kernels = [k for m in (sa_bwd, sa_fwd, sa_pair) for k in m.KERNELS]
    before = [k.launches for k in kernels]
    with pytest.raises(ValueError, match="TRUNK"):
        st.to(dev)(x.to(dev))
    assert [k.launches for k in kernels] == before


def test_select_knn_ball_bit_equal(dev, rng):
    """B4 against its twin and against B1's indices."""
    from facl_tpu_torch.ops.select import select_gather, select_knn_ball, \
        select_knn_ball_plain
    pts = torch.from_numpy(
        rng.uniform(-0.5, 0.5, size=(8, 512, 4)).astype(np.float32)).to(dev)
    i = select_knn_ball(pts, 64, 64, 0.06)
    assert torch.equal(i, select_knn_ball_plain(pts, 64, 64, 0.06))
    assert torch.equal(i, select_gather(pts, 64, 64, 0.06, True)[1])


@pytest.mark.parametrize("dist", ["uniform", "skewed"])
@pytest.mark.parametrize("R", [4096, 4000])
@pytest.mark.parametrize("N", [512, 7])
@pytest.mark.parametrize("C", [1, 3, 4, 8])
def test_gather_and_scatter_match_twins(dev, rng, C, N, R, dist):
    """B5a bit-equal; B5b (fixed order) against index_add_ (atomics) at
    1e-5 of the scale, and equal across two runs. skewed: 64 points own
    ~90% of the rows, as the padded centroids of the main path do."""
    from facl_tpu_torch.ops import gather as GA
    B = 6
    t = torch.from_numpy(rng.normal(size=(B, N, C)).astype(np.float32)).to(dev)
    i = rng.integers(0, N, size=(B, R))
    if dist == "skewed":
        hot = rng.choice(N, size=min(64, N), replace=False)
        i = np.where(rng.random((B, R)) < 0.9, rng.choice(hot, size=(B, R)),
                     i)
    idx = torch.from_numpy(i.astype(np.int32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(B, R, C)).astype(np.float32)).to(dev)
    assert torch.equal(GA.gather_rows(t, idx), GA.gather_rows_plain(t, idx))
    k, p = GA.scatter_add_rows(idx, g, N), GA.scatter_add_rows_plain(idx, g, N)
    assert float((k - p).abs().max()) <= 1e-5 * float(p.abs().max())
    assert torch.equal(k, GA.scatter_add_rows(idx, g, N))   # deterministic


def test_gather_and_scatter_unaligned(dev, rng):
    """Contiguous views that start 4 bytes past a 16-byte boundary take
    the kernels' word-copy and scalar paths: same results."""
    from facl_tpu_torch.ops import gather as GA
    B, N, R, C = 3, 64, 1000, 4

    def shifted(a):
        buf = torch.empty(a.size + 1, dtype=torch.from_numpy(a).dtype,
                          device=dev)
        v = buf[1:].view(a.shape)
        v.copy_(torch.from_numpy(a))
        return v
    t = shifted(rng.normal(size=(B, N, C)).astype(np.float32))
    idx = shifted(rng.integers(0, N, size=(B, R)).astype(np.int32))
    g = shifted(rng.normal(size=(B, R, C)).astype(np.float32))
    assert torch.equal(GA.gather_rows(t, idx), GA.gather_rows_plain(t, idx))
    k, p = GA.scatter_add_rows(idx, g, N), GA.scatter_add_rows_plain(idx, g, N)
    assert float((k - p).abs().max()) <= 1e-5 * float(p.abs().max())


def test_scatter_too_large_raises(dev):
    """A cloud whose B5b layout exceeds the block's shared memory raises
    ValueError before any launch; there is no fallback."""
    from facl_tpu_torch.ops import gather as GA
    R = 40000
    assert GA.scatter_smem(512, R, 4) > GA.MAX_SMEM
    idx = torch.zeros(1, R, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        GA.scatter_add_rows(idx, torch.zeros(1, R, 4, device=dev), 512)


@pytest.mark.parametrize("route", [("pallas", "pallas"), ("pallas", "xla"),
                                   ("xla", "pallas"), ("xla", "xla")])
def test_group_points_points_grad_card_vs_cpu(dev, rng, route):
    """d/d(points) through each grouping route: the card (B1 + B5b, B4, or
    B5a + B5b) against the CPU (twins)."""
    from facl_tpu_torch.ops.grouping import group_points
    pts = rng.uniform(-0.5, 0.5, size=(4, 256, 4)).astype(np.float32)
    w = torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))
    grads = []
    for d in ("cpu", dev):
        p = torch.from_numpy(pts).to(d).requires_grad_(True)
        n, c = group_points(p, 32, 32, 0.06, select_impl=route[0],
                            gather_impl=route[1])
        ((torch.sin(n) * w.to(d)).sum() + (c ** 2).sum()).backward()
        grads.append(p.grad.cpu())
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-5)
    assert torch.count_nonzero(grads[1][:, 32:]) > 0


def _b9_net(dev, rng, R, widths, C0=4):
    """Rows x (R, C0) and B9 layers of ``widths`` on the card."""
    from facl_tpu_torch.ops.fused_sa import SALayerParams
    x = torch.from_numpy(rng.normal(size=(R, C0)).astype(np.float32)).to(dev)
    lp, cin = [], C0
    for w in widths:
        lp.append(SALayerParams(*(torch.tensor(a, dtype=torch.float32,
                                               device=dev) for a in (
            rng.normal(size=(cin, w), scale=0.5),
            rng.normal(size=(w,), scale=0.1), 1 + 0.1 * rng.normal(size=(w,)),
            rng.normal(size=(w,), scale=0.1)))))
        cin = w
    return x, lp


#: f32_on_tensor_cores of the nets below: the main path's at pool 64 runs
#: the TF32 tensor-core kernel, every pool > 64 net the CUDA-core kernel;
#: the other nets run whichever their layout decides.
B9_F32_TC = {(64, (64, 64, 256)): True, (128, (64, 64, 256)): False}


@pytest.mark.parametrize("K,widths", [(64, (64, 64, 256)), (128, (64, 64, 256)),
                                      (8, (8, 16, 32)), (48, (32,))])
def test_b9_sweeps_match_twins(dev, rng, K, widths):
    """Each B9 sweep against its twin on the same card tensors: stats, BN
    sums and dW to 1e-4 of their max-abs; pooled and dx at rtol 1e-5 /
    atol 1e-5 x scale; db, whose exact value is zero (a BatchNorm follows
    each Dense), near zero on both. dpooled is zero where the float64
    recompute of the top layer has a near-tie (chip_smoke.py's
    near_ties). The kernel that runs is the one f32_on_tensor_cores names
    (B9_F32_TC), and each sweep launches it."""
    _b9_vs_twins(dev, rng, K, widths, B9_F32_TC.get((K, widths)))


def _b9_vs_twins(dev, rng, K, widths, tensor_cores=None):
    """test_b9_sweeps_match_twins's checks; ``tensor_cores`` the route
    f32_on_tensor_cores must give (None: either)."""
    from facl_tpu_torch.ops import sa_kernel as SK
    from facl_tpu_torch.ops.fused_sa import SALayerParams
    R, C0 = 16 * K, 4
    x, lp = _b9_net(dev, rng, R, widths, C0)
    tc = SK.f32_on_tensor_cores(R, C0, list(widths), K)
    assert tensor_cores is None or tc == tensor_cores
    before = [k.launches for k in SK.KERNELS[:4]]

    def acc(k, t):
        err, scale = float((k - t).abs().max()), float(t.abs().max())
        assert err <= 1e-4 * scale, (err, scale)

    def row(k, t):
        torch.testing.assert_close(k, t, rtol=1e-5,
                                   atol=1e-5 * float(t.abs().max()))

    pooled, stats, packed = SK.sa_train_forward_unified(x, lp, K)
    for l in range(len(widths)):
        for a, b in zip(SK.sa_fused_stats(x, lp, packed, K, l),
                        SK.sa_fused_stats_plain(x, lp, packed, K, l)):
            acc(a, b)
    row(pooled, SK.sa_fused_pool_plain(x, lp, packed, K))
    v = SK.vectors(lp, packed, None, R).double()
    ps, hs = SK._forward_plain(x.double(), [SALayerParams(
        *(t.double() for t in l)) for l in lp], v, len(lp) - 1)
    wt = widths[-1]
    z = (hs[-1] @ lp[-1].kernel.double() + v[-1, 0, :wt]) * v[-1, 3, :wt] \
        + v[-1, 4, :wt]
    zg = z.reshape(-1, K, wt)
    zmax = zg.amax(1, keepdim=True)
    gap = zmax - zg
    tol = 1e-5 * float(z.abs().max())
    near = (zmax[:, 0].abs() <= tol) | \
        ((zmax[:, 0] > 0) & ((gap > 0) & (gap <= tol)).any(1))
    dout = torch.from_numpy(rng.normal(size=(R // K, wt)).astype(np.float32)
                            ).to(dev)
    dout = torch.where(near.to(dev), 0.0, dout)
    bsums = torch.zeros_like(packed)
    for l in reversed(range(len(widths))):
        k = SK.sa_fused_bnsum(x, lp, packed, bsums, dout, K, l)
        t = SK.sa_fused_bnsum_plain(x, lp, packed, bsums, dout, K, l)
        for a, b in zip(k, t):
            acc(a, b)
        bsums[l, 0, :widths[l]], bsums[l, 1, :widths[l]] = t
    kd, kw, kb = SK.sa_fused_final(x, lp, packed, bsums, dout, K)
    td, tw, tb = SK.sa_fused_final_plain(x, lp, packed, bsums, dout, K)
    row(kd, td)
    for a, b in zip(kw, tw):
        acc(a, b)
    gscale = max(float(t.abs().max()) for t in tw)
    for a, b in zip(kb, tb):
        assert max(float(a.abs().max()), float(b.abs().max())) < \
            1e-4 * gscale
    assert SK.sa_fused_final(x, lp, packed, bsums, dout, K, False)[0] is None
    L = len(widths)
    assert [k.launches - n for k, n in zip(SK.KERNELS[:4], before)] == \
        [2 * L, 1, L, 2]


@pytest.mark.parametrize("widths,smem", [((80, 64, 256), 223232),
                                         ((64, 112, 256), 155648)])
def test_b9_wider_nets_match_twins(dev, rng, widths, smem):
    """Nets wider than the main path's at pool 64, held as the others: (80,
    64, 256) on the TF32 tensor cores at 64-row tiles (its layout fits);
    (64, 112, 256) on the CUDA-core kernel (the tensor-core layout would
    need 313,856 B). ``smem``: the bytes of the kernel that runs."""
    import ctypes
    from facl_tpu_torch.ops import _build
    from facl_tpu_torch.ops import sa_kernel as SK
    fn = _build.REGISTRY.get("sa_fused").facl_sa_fused_smem
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    assert fn(16 * 64, 4, len(widths), ctypes.cast(
        SK._widths_arg(list(widths)), ctypes.c_void_p), 64) == smem
    _b9_vs_twins(dev, rng, 64, widths, widths == (80, 64, 256))


def _b9_all(SK, x, lp, K, dout):
    """Every B9 sweep once in a stage's order, each fed the kernels' own
    statistics and BN sums -> their outputs, flat."""
    from facl_tpu_torch.ops.sa_fwd import _finalize
    widths = [t.kernel.shape[1] for t in lp]
    R, L = x.shape[0], len(lp)
    packed = torch.zeros(L, 2, max(widths), device=x.device)
    outs = []
    for l, w in enumerate(widths):
        s = SK.sa_fused_stats(x, lp, packed.clone(), K, l)
        outs += list(s)
        mean, var = _finalize(s[0], s[1], R)
        packed[l, 0, :w], packed[l, 1, :w] = mean, torch.rsqrt(var + 1e-5)
    outs.append(SK.sa_fused_pool(x, lp, packed, K))
    bsums = torch.zeros_like(packed)
    for l in reversed(range(L)):
        s = SK.sa_fused_bnsum(x, lp, packed, bsums.clone(), dout, K, l)
        outs += list(s)
        bsums[l, 0, :widths[l]], bsums[l, 1, :widths[l]] = s
    dx, dws, dbs = SK.sa_fused_final(x, lp, packed, bsums, dout, K)
    return outs + [dx] + dws + dbs


@pytest.mark.parametrize("K,widths", [(64, (64, 64, 256)),
                                      (128, (64, 64, 256)), (8, (8, 16, 32))])
def test_b9_two_runs_bit_identical(dev, rng, K, widths):
    """Two runs of B9's eight sweeps on the same inputs give bit-identical
    outputs (no atomics; sums in a fixed order), on either kernel."""
    from facl_tpu_torch.ops import sa_kernel as SK
    R = 16 * K
    x, lp = _b9_net(dev, rng, R, widths)
    dout = torch.from_numpy(rng.normal(size=(R // K, widths[-1]))
                            .astype(np.float32)).to(dev)
    a, b = _b9_all(SK, x, lp, K, dout), _b9_all(SK, x, lp, K, dout)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_b9_sweeps_agree_on_masks_and_routing(dev, rng):
    """The sweeps' discrete decisions agree across launches on the main
    path's net (TF32 tensor cores): (1) with dout = 1 the top layer's BN
    sum of dy counts, per channel, the groups whose pooled max is positive
    in the pool sweep (each such group routes its 1 to its max row, an
    exact count in f32), and the final sweep's db of the top (BN sums
    zero: db = gi x that count) counts the same; (2) with dout = 0 and the
    top's sum dy set, dp2 is one constant row, so da1 is too, and layer
    1's BN-sum sweep (sum dy1 = d1 x the rows its ReLU mask keeps) and
    the final sweep (db1 = gi1 d1 x the same rows) count the same masked
    rows (their ratio within 1e-4 of 1; one row of ~500 would move it
    2e-3); (3) at pool 1 with every top y > 0 the pool sweep returns p2
    itself, and the top layer's stats sweep sums the same p2 (within f32
    summation)."""
    from facl_tpu_torch.ops import sa_kernel as SK
    from facl_tpu_torch.ops.fused_sa import SALayerParams
    from facl_tpu_torch.ops.sa_fwd import _finalize
    K, widths = 64, (64, 64, 256)
    R = 16 * K
    x, lp = _b9_net(dev, rng, R, widths)
    assert SK.f32_on_tensor_cores(R, 4, list(widths), K)
    packed = torch.zeros(3, 2, 256, device=dev)
    for l, w in enumerate(widths):
        mean, var = _finalize(*SK.sa_fused_stats(x, lp, packed.clone(), K, l),
                              R)
        packed[l, 0, :w], packed[l, 1, :w] = mean, torch.rsqrt(var + 1e-5)
    pooled = SK.sa_fused_pool(x, lp, packed, K)
    live = (pooled > 0).sum(0).double()
    assert float(live.sum()) > 0
    ones = torch.ones_like(pooled)
    zero = torch.zeros(3, 2, 256, device=dev)
    s_dy, _ = SK.sa_fused_bnsum(x, lp, packed, zero, ones, K, 2)
    assert torch.equal(s_dy.double(), live)
    gi = (lp[2].scale * packed[2, 1]).double()
    db2 = SK.sa_fused_final(x, lp, packed, zero, ones, K, False)[2][2]
    assert torch.equal(torch.round(db2.double() / gi), live)

    bs = torch.zeros(3, 2, 256, device=dev)
    bs[2, 0] = torch.from_numpy(rng.normal(size=256).astype(np.float32)
                                ).to(dev) * R
    nil = torch.zeros_like(pooled)
    s_dy1, _ = SK.sa_fused_bnsum(x, lp, packed, bs, nil, K, 1)
    _, _, dbs = SK.sa_fused_final(x, lp, packed, bs, nil, K, False)
    gi1 = (lp[1].scale * packed[1, 1, :64]).double()
    kept = s_dy1 != 0                   # channels whose mask keeps a row
    assert int(kept.sum()) > 32
    ratio = dbs[1].double()[kept] / (gi1[kept] * s_dy1.double()[kept])
    assert float((ratio - 1).abs().max()) < 1e-4     # one row is ~2e-3

    x1 = x[:256]
    lp1 = lp[:2] + [SALayerParams(lp[2].kernel, lp[2].bias + 100.0,
                                  torch.ones_like(lp[2].scale),
                                  torch.zeros_like(lp[2].shift))]
    pk = packed.clone()
    for l, w in enumerate(widths[:2]):
        mean, var = _finalize(*SK.sa_fused_stats(x1, lp1, pk.clone(), 1, l),
                              256)
        pk[l, 0, :w], pk[l, 1, :w] = mean, torch.rsqrt(var + 1e-5)
    pk[2, 0], pk[2, 1] = 0.0, 1.0
    p2 = SK.sa_fused_pool(x1, lp1, pk, 1)
    assert float(p2.min()) > 0
    s, ss = SK.sa_fused_stats(x1, lp1, pk, 1, 2)
    for k, t in ((s, p2.double().sum(0)), (ss, (p2.double() ** 2).sum(0))):
        assert float((k.double() - t).abs().max()) <= \
            1e-6 * float(t.abs().max())


@pytest.mark.parametrize("case", ["count_K-1", "count_K", "count_K+1",
                                  "ties_at_K", "duplicates",
                                  "all_out_of_radius", "N_100", "N_1024"])
def test_select_cases_bit_equal(dev, rng, case):
    """B1 (with idx) and B4 on the selection's edge cases of
    tests/test_torch_select.py (in-ball counts K - 1, K and K + 1, a tie
    across the K-th key, duplicates, nothing in the ball, N = 100 and
    1024): bit-equal to the twin, each launching its kernel."""
    from test_torch_select import select_cases
    from facl_tpu_torch.ops import select as SEL
    pts, S, K, r2 = select_cases(rng)[case]
    p = torch.from_numpy(pts).to(dev)
    before = (SEL.select_gather.launches, SEL.select_knn_ball.launches)
    g, i = SEL.select_gather(p, S, K, r2, return_idx=True)
    i4 = SEL.select_knn_ball(p, S, K, r2)
    assert (SEL.select_gather.launches, SEL.select_knn_ball.launches) == \
        (before[0] + 1, before[1] + 1)
    gp, ip = SEL.select_gather_plain(p, S, K, r2)
    assert torch.equal(i, ip) and torch.equal(g, gp) and torch.equal(i4, ip)


@pytest.mark.parametrize("B,N", [(4, 96), (3, 320), (2, 1024)])
def test_b2a_layer12_matches_twin(dev, rng, B, N):
    """B2a (sa_fwd_layer12: 3xTF32 tensor cores, x by TMA) against its
    twin: p2 at rtol 1e-5 / atol 1e-5 x scale, the sums of p2 and p2^2
    within 1e-4 of their max-abs, two calls bit-identical. N % 64 != 0
    (96, 320) puts tiles across two clouds: the kernel reads those rows
    itself, and launches all the same."""
    from facl_tpu_torch.ops import sa_pair as SP
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    (w1, b1, _, _), (w2, b2, _, _), _ = \
        [[t(a) for a in layer] for layer in _layers(rng)]
    x3 = t(rng.normal(size=(B, 4, N)))
    mul1, shift1 = t(2 * rng.normal(size=64)), t(rng.normal(size=64))
    args = (x3, w1, b1, mul1, shift1, w2, b2)
    n0 = SP.sa_fwd_layer12.launches
    k, tw = SP.sa_fwd_layer12(*args), SP.sa_fwd_layer12_plain(*args)
    assert SP.sa_fwd_layer12.launches == n0 + 1
    torch.testing.assert_close(k[0], tw[0], rtol=1e-5,
                               atol=1e-5 * float(tw[0].abs().max()))
    for a, b in zip(k[1:], tw[1:]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    assert all(torch.equal(a, b) for a, b in zip(k, SP.sa_fwd_layer12(*args)))


def test_b2a_misaligned_x_raises(dev):
    """B2a stages x by 16-byte TMA copies: an x 4 bytes past a 16-byte
    boundary raises ValueError before any launch; there is no fallback."""
    from facl_tpu_torch.ops import sa_pair as SP
    x3 = torch.zeros(4 * 256 + 1, device=dev)[1:].view(1, 4, 256)
    w1, w2 = torch.zeros(4, 64, device=dev), torch.zeros(64, 64, device=dev)
    v64 = torch.ones(64, device=dev)
    n0 = SP.sa_fwd_layer12.launches
    with pytest.raises(ValueError, match="aligned"):
        SP.sa_fwd_layer12(x3, w1, v64, v64, v64, w2, v64)
    assert SP.sa_fwd_layer12.launches == n0
