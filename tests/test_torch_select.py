"""Kernel B1 (fused kNN + ball-query select+gather) of the PyTorch port
against the JAX package's TPU kernel run in interpret mode
(facl_tpu/ops/pallas/select.py::_select_gather).

On the CPU the port runs the kernel's plain twin. The twin computes the
squared distances with the same rounded operations in the same order as
the TPU kernel's reference formula, and selection/gather are exact
integer and copy operations, so idx and grouped must be EQUAL, not close.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu.ops.grouping import group_points as jax_group_points
from facl_tpu.ops.grouping import pairwise_sqdist as jax_pairwise_sqdist
from facl_tpu.ops.pallas.select import _select_gather
from facl_tpu.ops.pallas.select import select_knn_ball as jax_select_knn_ball
from facl_tpu_torch.config import GroupingConfig
from facl_tpu_torch.ops.grouping import group_points, group_points_cfg, \
    pairwise_sqdist
from facl_tpu_torch.ops.select import select_gather, select_knn_ball

CASES = ["random", "wide_ball", "duplicates", "all_out_of_radius"]
ROUTES = [("pallas", "pallas"), ("pallas", "xla"), ("xla", "pallas"),
          ("xla", "xla")]


def _clouds(rng, case):
    if case == "random":
        return rng.uniform(-0.5, 0.5, size=(3, 64, 4)).astype(np.float32), \
            0.06
    if case == "wide_ball":
        return rng.uniform(-0.5, 0.5, size=(3, 64, 4)).astype(np.float32), \
            10.0
    if case == "duplicates":      # every point twice: exact distance ties
        base = rng.uniform(-0.5, 0.5, size=(2, 32, 4)).astype(np.float32)
        return np.concatenate([base, base], axis=1), 0.4
    pts = np.zeros((2, 64, 4), np.float32)   # all out of radius
    pts[..., :3] = rng.normal(size=(2, 64, 3)) * 10.0
    pts[..., 3] = rng.normal(size=(2, 64))
    return pts, 1e-6


@pytest.mark.parametrize("case", CASES)
def test_select_gather_equals_tpu_kernel(rng, case):
    pts, r2 = _clouds(rng, case)
    S, K = 8, 12
    jg, jidx = _select_gather(jnp.asarray(pts), S, K, r2, interpret=True,
                              channels_first=True)
    tg, tidx = select_gather(torch.from_numpy(pts), S, K, r2,
                             return_idx=True)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    if case == "all_out_of_radius":
        s = np.arange(S)[None, :, None]
        assert (tidx.numpy() == s).all()


@pytest.mark.parametrize("layout", ["bskc", "bcsk"])
def test_group_points_equals_jax_fused_path(rng, layout):
    pts = rng.uniform(-0.5, 0.5, size=(2, 48, 4)).astype(np.float32)
    jn, jc = jax_group_points(jnp.asarray(pts), 8, 8, 0.2,
                              select_impl="pallas", gather_impl="pallas",
                              layout=layout)
    tn, tc = group_points(torch.from_numpy(pts), 8, 8, 0.2, layout=layout)
    assert tuple(tn.shape) == jn.shape
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


def test_pairwise_sqdist_matches_jax(rng):
    # The two frameworks contract a.b in their own order, so the
    # |a|^2 - 2ab + |b|^2 identity agrees to a few ulps of its terms
    # (~1 here), not bit for bit; exact zeros come from the clamp.
    a = rng.normal(size=(2, 8, 3)).astype(np.float32)
    b = rng.normal(size=(2, 48, 3)).astype(np.float32)
    b[:, :8] = a                  # self-distances: clamped at 0, never < 0
    jd = np.asarray(jax_pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)))
    td = pairwise_sqdist(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert td.shape == jd.shape == (2, 8, 48)
    assert (td >= 0).all()
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
def test_select_knn_ball_equals_tpu_kernel(rng, case):
    """B4: the selection alone, bit-equal to the TPU kernel and to B1's."""
    pts, r2 = _clouds(rng, case)
    S, K = 8, 12
    jidx = jax_select_knn_ball(jnp.asarray(pts), S, K, r2, interpret=True)
    tidx = select_knn_ball(torch.from_numpy(pts), S, K, r2)
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _, b1_idx = select_gather(torch.from_numpy(pts), S, K, r2,
                              return_idx=True)
    assert torch.equal(tidx, b1_idx)


@pytest.mark.parametrize("select_impl,gather_impl", ROUTES)
def test_group_points_routes_equal_jax(rng, select_impl, gather_impl):
    """Each (select_impl, gather_impl) route, through group_points_cfg,
    against JAX's group_points with the same arguments: centers exact, neighbourhoods exact once each channel is
    sorted over K (the routes list neighbours in different orders)."""
    pts = rng.uniform(-0.5, 0.5, size=(2, 48, 4)).astype(np.float32)
    jn, jc = jax_group_points(jnp.asarray(pts), 8, 8, 0.2,
                              select_impl=select_impl,
                              gather_impl=gather_impl)
    tn, tc = group_points_cfg(torch.from_numpy(pts), GroupingConfig(
        num_centroids=8, knn_k=8, radius_sq=0.2, select_impl=select_impl,
        gather_impl=gather_impl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(np.sort(tn.numpy(), axis=2),
                                  np.sort(np.asarray(jn), axis=2))


@pytest.mark.parametrize("select_impl,gather_impl", ROUTES)
def test_group_points_points_grad_equals_jax(rng, select_impl, gather_impl):
    """d/d(points) of tests/test_pallas_select.py's set-invariant loss on
    every route, against jax.grad: the gather term reaches the points
    through B1's and B5a's scatter-add backward, the centers term through
    the re-centring."""
    B, N, S, K = 2, 96, 12, 16
    base = rng.uniform(-0.5, 0.5, size=(B, N // 2, 4)).astype(np.float32)
    pts = np.concatenate([base, base], axis=1)

    # jax.grad cannot pass the selection-only pallas_call (it has no VJP
    # rule, even for its integer output); the xla selection picks the same
    # index set, so it gives that route's reference gradient.
    jsel = "xla" if (select_impl, gather_impl) == ("pallas", "xla") \
        else select_impl

    def jloss(p):
        n, c = jax_group_points(p, S, K, 0.2, select_impl=jsel,
                                gather_impl=gather_impl)
        return jnp.sum(n ** 2) + jnp.sum(c ** 2)

    gj = jax.grad(jloss)(jnp.asarray(pts))
    tp = torch.from_numpy(pts).requires_grad_(True)
    n, c = group_points(tp, S, K, 0.2, select_impl=select_impl,
                        gather_impl=gather_impl)
    ((n ** 2).sum() + (c ** 2).sum()).backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-5)
    # The gather term is there: without it only the centroids' rows move.
    assert torch.count_nonzero(tp.grad[:, S:]) > 0


def test_group_points_rejects_unknown_impl_and_approx():
    """Unknown impls and methods raise; ``method="approx"`` is ported
    (the plain selection, tests/test_torch_extract.py holds it against
    JAX) and runs on every select_impl."""
    pts = torch.zeros(1, 16, 4)
    with pytest.raises(ValueError, match="select_impl"):
        group_points(pts, 4, 4, select_impl="cuda")
    with pytest.raises(ValueError, match="method"):
        group_points(pts, 4, 4, method="approximate")
    for si in ("auto", "pallas", "xla"):
        n, c = group_points(pts, 4, 4, method="approx", select_impl=si)
        assert n.shape == (1, 4, 4, 4) and c.shape == (1, 4, 3)


# -- B1's selection as the CUDA kernel makes it (csrc/select.cu) ----------
# A counting pass; with more than K points in the ball, a radix select of
# the K-th key over the bits in which the candidates differ (first the
# range [0, bits(r^2)], then each chosen bin's min and max), 8 bits a pass,
# until the bin is one value or holds at most 32 keys (ranked against each
# other); then the tie rule, with one test (key <= t) where every tie is
# taken.

OUT = 0xFFFFFFFF


def radix_kth(w, k, rbits):
    """(t, take, ties, passes) for uint32 keys w (out of the ball: OUT):
    the kernel's select_kth."""
    lo, hi, ties, passes = 0, rbits, -1, 0
    while True:
        if lo == hi:
            return lo, k, ties, passes
        passes += 1
        hb = (lo ^ hi).bit_length() - 1
        sh = max(hb - 7, 0)
        dmask = (2 << (hb - sh)) - 1
        cand = w[(w >= lo) & (w <= hi)]
        hist = np.bincount((cand >> sh) & dmask, minlength=256)
        cum = np.cumsum(hist)
        b = int(np.argmax(cum >= k))
        k -= int(cum[b] - hist[b])
        ties = int(hist[b])
        base = ((lo >> (hb + 1)) << (hb + 1)) | (b << sh)
        if sh == 0:
            return base, k, ties, passes
        c = w[(w >= base) & (w <= base + (1 << sh) - 1)]
        assert len(c) == ties
        if ties <= 32:           # ranked one a lane: less < k <= less + eq
            less = (c[None, :] < c[:, None]).sum(1)
            eq = (c[None, :] == c[:, None]).sum(1)
            m = int(np.argmax((less < k) & (k <= less + eq)))
            return int(c[m]), k - int(less[m]), int(eq[m]), passes
        lo, hi = int(c.min()), int(c.max())


def radix_select_idx(points, S, K, radius_sq):
    """idx (B, S, K) int32 by the kernel's algorithm, on the twin's
    distances (the same rounded chain as the kernel's)."""
    from facl_tpu_torch.ops.select import sqdist_to_centroids
    d = sqdist_to_centroids(torch.from_numpy(points), S).numpy()
    r2 = np.float32(radius_sq)
    keys = np.where(d <= r2, d.view(np.uint32), np.uint32(OUT)).astype(
        np.int64)
    rbits = int(np.array(r2, np.float32).view(np.uint32))
    B, _, N = keys.shape
    out = np.empty((B, S, K), np.int32)
    stats = []
    for b in range(B):
        for s in range(S):
            w = keys[b, s]
            inball = w != OUT
            if int(inball.sum()) <= K:
                sel = inball
            else:
                t, take, ties, passes = radix_kth(w, K, rbits)
                srt = np.sort(w)
                assert t == srt[K - 1]                  # the K-th key
                assert take == K - int((w < t).sum())   # ties to take
                stats.append(passes)
                if take == ties:
                    sel = w <= t
                else:
                    tie = w == t
                    sel = (w < t) | (tie & (np.cumsum(tie) - 1 < take))
            n = np.nonzero(sel)[0]
            out[b, s] = np.concatenate([n, np.full(K - len(n), s)])
    return out, stats


def _count_in_ball(pts, S, r2):
    from facl_tpu_torch.ops.select import sqdist_to_centroids
    d = sqdist_to_centroids(torch.from_numpy(pts), S).numpy()
    return (d <= np.float32(r2)).sum(-1)


def select_cases(rng):
    """name -> (points (B, N, C) f32, S, K, r^2): the selection's edges.
    count_K-1 / count_K / count_K+1: centroid 0 of cloud 0 holds exactly
    that many points in its ball; ties_at_K: six copies of one point sit
    at ranks 9-14 of centroid 0's keys, straddling the K-th (K = 12)."""
    cases = {}
    S, K = 8, 12
    base = rng.uniform(-0.5, 0.5, size=(2, 64, 4)).astype(np.float32)
    from facl_tpu_torch.ops.select import sqdist_to_centroids
    d0 = np.sort(sqdist_to_centroids(torch.from_numpy(base), S).numpy()[0, 0])
    for m in (K - 1, K, K + 1):
        r2 = float(np.float32((d0[m - 1] + d0[m]) / 2))
        assert _count_in_ball(base, S, r2)[0, 0] == m
        cases[f"count_K{m - K:+d}".replace("+0", "")] = (base, S, K, r2)
    tied = base.copy()
    order = np.argsort(sqdist_to_centroids(torch.from_numpy(tied),
                                           S).numpy()[0, 0])
    far = [i for i in order[::-1] if i >= S][:5]
    tied[0, far] = tied[0, order[8]]            # ranks 8..13 (0-based)
    cases["ties_at_K"] = (tied, S, K, 0.3)
    half = rng.uniform(-0.5, 0.5, size=(2, 32, 4)).astype(np.float32)
    cases["duplicates"] = (np.concatenate([half, half], 1), S, K, 0.4)
    far_pts = np.zeros((2, 64, 4), np.float32)
    far_pts[..., :3] = rng.normal(size=(2, 64, 3)) * 10.0
    cases["all_out_of_radius"] = (far_pts, S, K, 1e-6)
    cases["N_100"] = (rng.uniform(-0.5, 0.5, size=(2, 100, 3))
                      .astype(np.float32), 16, 12, 0.3)
    cases["N_1024"] = (rng.uniform(0, 1, size=(2, 1024, 4))
                       .astype(np.float32), 8, 64, 0.1)
    return cases


SELECT_CASES = ["count_K-1", "count_K", "count_K+1", "ties_at_K",
                "duplicates", "all_out_of_radius", "N_100", "N_1024"]


@pytest.mark.parametrize("case", SELECT_CASES)
def test_radix_selection_equals_twin_and_tpu_kernel(rng, case):
    """The kernel's selection (counting shortcut, radix select of the K-th
    key, tie rule), emulated, against the twin and the TPU kernel in
    interpret mode: bit-equal idx."""
    from facl_tpu_torch.ops.select import select_knn_ball_plain
    pts, S, K, r2 = select_cases(rng)[case]
    idx, passes = radix_select_idx(pts, S, K, r2)
    twin = select_knn_ball_plain(torch.from_numpy(pts), S, K, r2).numpy()
    np.testing.assert_array_equal(idx, twin)
    tpu = np.asarray(jax_select_knn_ball(jnp.asarray(pts), S, K, r2,
                                         interpret=True))
    np.testing.assert_array_equal(idx, tpu)
    n = _count_in_ball(pts, S, r2)
    assert len(passes) == int((n > K).sum())    # selection only past K
    if case == "count_K+1":
        assert n[0, 0] == K + 1 and len(passes) > 0
    if case == "ties_at_K":
        from facl_tpu_torch.ops.select import sqdist_to_centroids
        w = np.sort(sqdist_to_centroids(torch.from_numpy(pts), S)
                    .numpy()[0, 0])
        assert w[K - 2] == w[K - 1] == w[K]     # a tie across the K-th
    if case == "all_out_of_radius":
        assert (idx == np.arange(S)[None, :, None]).all()
    if case == "N_1024":
        assert 1 <= max(passes) <= 4
