"""B6s: the port's pair / pair3 SA stage under data parallelism (each rank
runs the sweeps' twins on its block of the batch; the sweep accumulators
are summed over the ranks between the sweeps), on two gloo ranks on the
CPU, against the JAX package's UNSHARDED pair stage
(``sa_train_pair_cf`` with its Pallas kernels in interpret mode), at the
case and bars of tests/test_sa_pair.py:297-349 (B=16, S=4, K=8, C=4,
widths (8, 8, 16); slim and non-slim): statistics at rtol 1e-5 / atol 1e-6
(means) and rtol 1e-4 / atol 1e-6 (variances), parameter gradients at
rtol 5e-4 / atol 5e-5. The gradients come back global: the same on both
ranks, and not dp times the unsharded ones. pair3 and pair at bf16 are
held against the port's own one-process bf16 stage at the same bars."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu.ops.pallas.sa_pair import sa_train_pair_cf
from facl_tpu_torch.ops.fused_sa import SALayerParams
from facl_tpu_torch.ops.sa_pair import sa_train_pair
from facl_tpu_torch.parallel import spawn
from tests.test_analytic_sa import make_layers
from tests.torch_dp_ranks import sharded_pair_body

B, S, K, C = 16, 4, 8, 4            # 8 batch rows a rank (even)
WIDTHS = (8, 8, 16)
EPS = 1e-5
F32, BF16 = torch.float32, torch.bfloat16
CASES = ((False, F32), (True, F32), (False, BF16), (True, BF16))
NAMES = ("kernel", "bias", "scale", "shift")


def _jax(x_cf, layers, wvec, slim):
    def loss(layers):
        pooled, stats = sa_train_pair_cf(x_cf, layers, EPS, jnp.float32,
                                         True, slim)
        return jnp.sum(jnp.sin(pooled) * wvec), (pooled, stats)
    (l, (pooled, stats)), g = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(layers)
    return dict(loss=float(l), pooled=np.asarray(pooled),
                stats=[(np.asarray(m), np.asarray(v)) for m, v in stats],
                grads=[[np.asarray(getattr(lp, n)) for n in NAMES]
                       for lp in g])


def _one_process(x_cf, layers, wvec, slim, dtype):
    ps = [SALayerParams(*(torch.tensor(a).requires_grad_() for a in lp))
          for lp in layers]
    pooled, stats = sa_train_pair(torch.from_numpy(x_cf), ps, EPS,
                                  slim=slim, dtype=dtype)
    (torch.sin(pooled.float()) * torch.from_numpy(wvec)).sum().backward()
    return dict(pooled=pooled.detach(),
                stats=[(m.detach(), v.detach()) for m, v in stats],
                grads=[[t.grad for t in lp] for lp in ps])


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, S, K, C)).astype(np.float32)
    x_cf = np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))
    layers = make_layers(rng, WIDTHS, C)
    wvec = rng.normal(size=(WIDTHS[-1],)).astype(np.float32)
    np_layers = [tuple(np.asarray(t) for t in lp) for lp in layers]
    jax_out = {slim: _jax(jnp.asarray(x_cf), layers, jnp.asarray(wvec), slim)
               for slim in (False, True)}
    one = {slim: _one_process(x_cf, np_layers, wvec, slim, BF16)
           for slim in (False, True)}
    ranks = spawn(sharded_pair_body, 2, "gloo",
                  args=(torch.from_numpy(x_cf), np_layers,
                        torch.from_numpy(wvec), CASES), timeout_s=180)
    return jax_out, one, ranks


def _check_stats(got, want):
    for (ms, vs), (mr, vr) in zip(got, want):
        np.testing.assert_allclose(np.asarray(ms), np.asarray(mr),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(vs), np.asarray(vr),
                                   rtol=1e-4, atol=1e-6)


def _check_global_grads(ranks, case, want):
    """Both ranks hold the same global gradients, at the bars against
    ``want``, and their norm is want's (not dp times it)."""
    g0, g1 = ranks[0][case]["grads"], ranks[1][case]["grads"]
    for i, (l0, l1, lw) in enumerate(zip(g0, g1, want)):
        for name, a, b, w in zip(NAMES, l0, l1, lw):
            assert torch.equal(a, b), f"layer {i} {name}: ranks differ"
            w = np.asarray(w, np.float32)
            np.testing.assert_allclose(a.numpy(), w, rtol=5e-4, atol=5e-5,
                                       err_msg=f"layer {i} {name}")
    num = sum(float(t.norm()) ** 2 for lp in g0 for t in lp)
    den = sum(float(np.linalg.norm(w)) ** 2 for lp in want for w in lp)
    assert abs((num / den) ** 0.5 - 1) < 1e-3


@pytest.mark.parametrize("slim", [False, True], ids=["pair", "pair3"])
def test_sharded_pair_matches_jax_unsharded(runs, slim):
    jax_out, _, ranks = runs
    case, want = (slim, F32), jax_out[slim]
    loss = sum(float(r[case]["loss"]) for r in ranks)
    np.testing.assert_allclose(loss, want["loss"], rtol=1e-5)
    pooled = torch.cat([r[case]["pooled"] for r in ranks]).numpy()
    np.testing.assert_allclose(pooled, want["pooled"], rtol=1e-4, atol=1e-5)
    for r in ranks:
        _check_stats(r[case]["stats"], want["stats"])
    _check_global_grads(ranks, case, want["grads"])


@pytest.mark.parametrize("slim", [False, True], ids=["pair", "pair3"])
def test_b6s_all_reduces_per_step(runs, slim):
    """Three in the forward (Gram(x)/colsum(x); sums of p2, p2^2;
    Gram(h2)/colsum(h2)); in the backward three for pair3 (A3, u3; A2, G1,
    u2, ch1; A1, u1) and two for pair (A3, u3; B6's accumulators)."""
    _, _, ranks = runs
    for r in ranks:
        out = r[slim, F32]
        assert (out["psum_fwd"], out["psum_bwd"]) == (3, 3 if slim else 2)
        assert out["counts"]["psum"] == out["psum_fwd"] + out["psum_bwd"]
        assert sum(out["counts"].values()) == out["counts"]["psum"]


@pytest.mark.parametrize("slim", [False, True], ids=["pair", "pair3"])
def test_sharded_pair3_bf16_matches_one_process(runs, slim):
    _, one, ranks = runs
    case, one = (slim, BF16), one[slim]
    pooled = torch.cat([r[case]["pooled"] for r in ranks])
    assert pooled.dtype == BF16
    np.testing.assert_allclose(pooled.float().numpy(),
                               one["pooled"].float().numpy(), rtol=1e-2,
                               atol=1e-2)
    for r in ranks:
        _check_stats(r[case]["stats"], one["stats"])
    _check_global_grads(ranks, case, [[t.numpy() for t in lp]
                                      for lp in one["grads"]])


def test_sharded_pair_rejects_odd_rank_rows(runs):
    _, _, ranks = runs
    for r in ranks:
        assert "must be even" in r["odd_rows"]
