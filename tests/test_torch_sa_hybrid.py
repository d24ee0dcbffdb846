"""The port's ``hybrid`` SA path (plain forward + the two-sweep backward,
kernel B8; on the CPU its plain twins) and its ``analytic`` path against
the JAX package: ``sa_train_hybrid`` with its Pallas kernels in interpret
mode, ``sa_backward_pallas`` on shared inputs, and ``sa_train_analytic``.

Bars follow tests/test_sa_hybrid.py and tests/test_analytic_sa.py: the
forward is the same op sequence in both frameworks, so pooled values and
statistics agree to rtol 1e-5 (matmul summation order only); gradients
agree with JAX's same path at 1e-4 (same algebra) and with autodiff of
the plain reference at rtol 2e-3 / atol 2e-3 x their scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu.ops.analytic_sa import sa_train_analytic as jax_analytic
from facl_tpu.ops.pallas.sa_bwd import sa_backward_pallas
from facl_tpu.ops.pallas.sa_bwd import sa_train_hybrid as jax_hybrid
from facl_tpu_torch.ops.analytic_sa import sa_train_analytic
from facl_tpu_torch.ops.fused_sa import SALayerParams, sa_reference_4d
from facl_tpu_torch.ops.sa_bwd import sa_backward_2sweep, sa_train_hybrid
from tests.test_analytic_sa import make_layers
from tests.test_torch_sa_pair import _torch_layers

EPS = 1e-5
B, S, K, C0 = 2, 4, 8, 4
WIDTHS = (8, 8, 16)


def _setup(rng, ties=False, widths=WIDTHS):
    if ties:        # duplicated neighbourhood halves: exact pool ties
        half = rng.normal(size=(1, 2, K // 2, C0)).astype(np.float32)
        x = np.concatenate([half, half], axis=2)
    else:
        x = rng.normal(size=(B, S, K, C0)).astype(np.float32)
    layers = make_layers(rng, widths, C0)
    wvec = rng.normal(size=(widths[-1],)).astype(np.float32)
    return x, layers, wvec


def _loss_t(pooled, wvec):
    return (torch.sin(pooled) * torch.from_numpy(wvec)).sum()


def _jax_grads(fn, x, layers, wvec, *extra, argnums=1):
    def f(x, layers):
        pooled, _ = fn(x, layers, EPS, jnp.float32, *extra)
        return jnp.sum(jnp.sin(pooled) * wvec)
    return jax.grad(f, argnums=argnums)(jnp.asarray(x), layers)


def _assert_layers(tl, ref, rtol, atol, what):
    for i, (lt, lr) in enumerate(zip(tl, ref)):
        for name in ("kernel", "scale", "shift"):
            g = getattr(lt, name)
            g = (g.grad if g.requires_grad else g).numpy()
            r = np.asarray(getattr(lr, name))
            sc = max(1.0, float(np.abs(r).max()))
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol * sc,
                                       err_msg=f"{what} layer{i} {name}")


def _autodiff(x, layers, wvec):
    rl = _torch_layers(layers)
    pooled, _, _, _ = sa_reference_4d(torch.from_numpy(x), rl, EPS)
    _loss_t(pooled, wvec).backward()
    return [SALayerParams(*(t.grad for t in lp)) for lp in rl]


def test_hybrid_forward_matches_jax(rng):
    x, layers, _ = _setup(rng)
    jp, jstats = jax_hybrid(jnp.asarray(x), layers, EPS, jnp.float32, True)
    with torch.no_grad():
        tp, tstats = sa_train_hybrid(torch.from_numpy(x),
                                     _torch_layers(layers), EPS)
    assert tuple(tp.shape) == jp.shape == (B, S, WIDTHS[-1])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)
    for i, ((tm, tv), (jm, jv)) in enumerate(zip(tstats, jstats)):
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                                   atol=1e-6, err_msg=f"mean{i}")
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-6, err_msg=f"var{i}")


@pytest.mark.parametrize("ties", [False, True])
def test_hybrid_grads_match_jax_and_autodiff(rng, ties):
    x, layers, wvec = _setup(rng, ties)
    xt = torch.from_numpy(x).requires_grad_(True)
    tl = _torch_layers(layers)
    pooled, _ = sa_train_hybrid(xt, tl, EPS)
    _loss_t(pooled, wvec).backward()
    _assert_layers(tl, _jax_grads(jax_hybrid, x, layers, wvec, True), 1e-4,
                   1e-4, "vs jax hybrid")
    # Ties split evenly, as torch's amax and JAX's analytic path do.
    _assert_layers(tl, _jax_grads(jax_analytic, x, layers, wvec), 1e-4,
                   1e-4, "vs jax analytic")
    _assert_layers(tl, _autodiff(x, layers, wvec), 2e-3, 2e-3,
                   "vs autodiff")
    # Input cotangent is zero by contract (sa_bwd.py:37-39).
    assert xt.grad is not None and torch.count_nonzero(xt.grad) == 0


def test_two_sweep_backward_matches_jax_on_shared_inputs(rng):
    """sa_backward_2sweep (B8's twins) and JAX's sa_backward_pallas on the
    same rows, residuals, statistics and cotangent."""
    x, layers, _ = _setup(rng)
    rows = x.reshape(-1, C0)
    R = rows.shape[0]
    p1 = rng.normal(size=(R, WIDTHS[0])).astype(np.float32)
    p2 = rng.normal(size=(R, WIDTHS[1])).astype(np.float32)
    stats = [(rng.normal(size=(w,), scale=0.3).astype(np.float32),
              rng.uniform(0.5, 2.0, size=(w,)).astype(np.float32))
             for w in WIDTHS]
    dpooled = rng.normal(size=(R // K, WIDTHS[-1])).astype(np.float32)
    jg = sa_backward_pallas(
        jnp.asarray(rows), jnp.asarray(p1), jnp.asarray(p2), layers,
        [tuple(map(jnp.asarray, s)) for s in stats], jnp.asarray(dpooled),
        EPS, jnp.float32, interpret=True)
    with torch.no_grad():
        tg = sa_backward_2sweep(
            *(torch.from_numpy(a) for a in (rows, p1, p2)),
            [SALayerParams(*(torch.tensor(np.asarray(t)) for t in lp))
             for lp in layers],
            [tuple(map(torch.from_numpy, s)) for s in stats],
            torch.from_numpy(dpooled), K, EPS)
    _assert_layers([SALayerParams(*g) for g in tg], jg, 1e-4, 1e-4,
                   "sa_backward_2sweep")


@pytest.mark.parametrize("ties", [False, True])
def test_analytic_matches_jax(rng, ties):
    x, layers, wvec = _setup(rng, ties)
    jp, jstats = jax_analytic(jnp.asarray(x), layers, EPS, jnp.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    tl = _torch_layers(layers)
    tp, tstats = sa_train_analytic(xt, tl, EPS)
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=1e-5, atol=1e-6)
    for (tm, tv), (jm, jv) in zip(tstats, jstats):
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-6)
    _loss_t(tp, wvec).backward()
    jdx, jg = _jax_grads(jax_analytic, x, layers, wvec, argnums=(0, 1))
    _assert_layers(tl, jg, 1e-4, 1e-4, "vs jax analytic")
    # The only SA path with an input gradient: nonzero, and JAX's.
    assert torch.count_nonzero(xt.grad) > 0
    sc = max(1.0, float(np.abs(np.asarray(jdx)).max()))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-4,
                               atol=1e-4 * sc)
    # And autodiff of the plain reference, input gradient included.
    xr = torch.from_numpy(x).requires_grad_(True)
    rl = _torch_layers(layers)
    rp, _, _, _ = sa_reference_4d(xr, rl, EPS)
    _loss_t(rp, wvec).backward()
    _assert_layers(tl, [SALayerParams(*(t.grad for t in lp)) for lp in rl],
                   2e-3, 2e-3, "vs autodiff")
    sc = max(1.0, float(xr.grad.abs().max()))
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), rtol=2e-3,
                               atol=2e-3 * sc)
