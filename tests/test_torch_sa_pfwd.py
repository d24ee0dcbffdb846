"""The port's ``hybrid2`` SA path (the four-sweep forward, kernel B7, and
the two-sweep backward, B8; on the CPU their plain twins) against the JAX
package's ``sa_train_pfwd`` / ``sa_forward_pallas`` with their Pallas
kernels in interpret mode, and autodiff of the plain reference.

Bars are those of tests/test_sa_pfwd.py: the sweeps sum the moments in
another order than the reference (per-tile partials, the covariance
identity for layer 3), so pooled values and means are held at rtol 1e-4
/ atol 1e-5, variances at rtol 5e-4, gradients at rtol 2e-3 / atol 2e-3
x their scale; the p1/p2 residuals, one product each from the same
inputs, at rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from facl_tpu.ops.pallas.sa_fwd import sa_forward_pallas, sa_train_pfwd \
    as jax_pfwd
from facl_tpu_torch.ops.sa_fwd import sa_forward_4sweep, sa_train_pfwd
from tests.test_torch_sa_hybrid import C0, EPS, K, WIDTHS, _assert_layers, \
    _autodiff, _jax_grads, _loss_t, _setup
from tests.test_torch_sa_pair import _torch_layers


def _assert_stats(tstats, jstats):
    for i, ((tm, tv), (jm, jv)) in enumerate(zip(tstats, jstats)):
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-4,
                                   atol=1e-5, err_msg=f"mean{i}")
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=5e-4,
                                   atol=1e-5, err_msg=f"var{i}")


def test_pfwd_forward_and_residuals_match_jax(rng):
    x, layers, _ = _setup(rng)
    rows = x.reshape(-1, C0)
    jp, jstats, jp1, jp2 = sa_forward_pallas(jnp.asarray(rows), layers, K,
                                             EPS, jnp.float32, True)
    with torch.no_grad():
        tp, tstats, tp1, tp2 = sa_forward_4sweep(
            torch.from_numpy(rows), _torch_layers(layers), K, EPS)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4,
                               atol=1e-5)
    _assert_stats(tstats, jstats)
    np.testing.assert_allclose(tp1.numpy(), np.asarray(jp1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tp2.numpy(), np.asarray(jp2), rtol=1e-4,
                               atol=1e-5)


def test_pfwd_stage_matches_jax(rng):
    x, layers, _ = _setup(rng)
    jp, jstats = jax_pfwd(jnp.asarray(x), layers, EPS, jnp.float32, True)
    with torch.no_grad():
        tp, tstats = sa_train_pfwd(torch.from_numpy(x),
                                   _torch_layers(layers), EPS)
    assert tuple(tp.shape) == jp.shape
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4,
                               atol=1e-5)
    _assert_stats(tstats, jstats)


def test_pfwd_grads_match_jax_and_autodiff(rng):
    x, layers, wvec = _setup(rng)
    xt = torch.from_numpy(x).requires_grad_(True)
    tl = _torch_layers(layers)
    pooled, _ = sa_train_pfwd(xt, tl, EPS)
    _loss_t(pooled, wvec).backward()
    _assert_layers(tl, _jax_grads(jax_pfwd, x, layers, wvec, True), 2e-3,
                   2e-3, "vs jax hybrid2")
    _assert_layers(tl, _autodiff(x, layers, wvec), 2e-3, 2e-3,
                   "vs autodiff")
    assert xt.grad is not None and torch.count_nonzero(xt.grad) == 0
    assert pooled.shape[-1] == WIDTHS[-1]
