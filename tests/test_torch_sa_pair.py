"""The port's pair3 and pair SA stages (kernels B2/B3, and B6 for pair's
non-slim backward; on the CPU their plain twins) against the JAX package:
``sa_train_pair_cf(..., slim=True/False)`` with its Pallas kernels in
interpret mode, and autodiff of the reference math.

Bars are those of tests/test_sa_pair.py:29-61: the sweeps sum moments in
another order than the reference (tile partials, Gram identities), so
pooled/means are held at rtol 1e-4 / atol 1e-5, variances at rtol 5e-4,
and the closed-form gradients at rtol 2e-3 / atol 2e-3 x their scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu.ops.fused_sa import sa_eval_reference as jax_sa_eval_reference
from facl_tpu.ops.pallas.sa_pair import sa_train_pair_cf
from facl_tpu_torch.ops.fused_sa import SALayerParams, sa_eval_reference, \
    sa_train_reference
from facl_tpu_torch.ops.sa_pair import sa_train_pair, sa_train_pair3
from tests.test_analytic_sa import make_layers

EPS = 1e-5
B, C0, S, K = 2, 4, 4, 8
WIDTHS = (8, 8, 16)


def _setup(rng, negative_scale):
    x = rng.normal(size=(B, C0, S, K)).astype(np.float32)
    layers = list(make_layers(rng, WIDTHS, C0))
    if negative_scale:        # half the layer-3 channels take the min branch
        sc = np.asarray(layers[-1].scale).copy()
        sc[::2] *= -1.0
        layers[-1] = layers[-1]._replace(scale=jnp.asarray(sc))
    wvec = rng.normal(size=(WIDTHS[-1],)).astype(np.float32)
    return x, tuple(layers), wvec


def _torch_layers(layers):
    return [SALayerParams(*(torch.tensor(np.asarray(t), requires_grad=True)
                            for t in lp)) for lp in layers]


def _jax_grads(x, layers, wvec, slim=True):
    def f(layers):
        pooled, _ = sa_train_pair_cf(jnp.asarray(x), layers, EPS,
                                     jnp.float32, True, slim)
        return jnp.sum(jnp.sin(pooled) * wvec)
    return jax.grad(f)(layers)


def _assert_grads(tlayers, ref, what):
    for i, (lt, lr) in enumerate(zip(tlayers, ref)):
        for name in ("kernel", "scale", "shift"):
            p = getattr(lt, name).grad.numpy()
            r = np.asarray(getattr(lr, name))
            sc = max(1.0, float(np.abs(r).max()))
            np.testing.assert_allclose(p, r, rtol=2e-3, atol=2e-3 * sc,
                                       err_msg=f"{what} layer{i} {name}")


@pytest.mark.parametrize("negative_scale", [False, True])
def test_pair3_forward_matches_jax(rng, negative_scale):
    x, layers, _ = _setup(rng, negative_scale)
    jp, jstats = sa_train_pair_cf(jnp.asarray(x), layers, EPS, jnp.float32,
                                  True, True)
    with torch.no_grad():
        tp, tstats = sa_train_pair3(torch.from_numpy(x),
                                    _torch_layers(layers), EPS)
    assert tuple(tp.shape) == jp.shape == (B, S, WIDTHS[-1])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-4,
                               atol=1e-5)
    for i, ((tm, tv), (jm, jv)) in enumerate(zip(tstats, jstats)):
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-4,
                                   atol=1e-5, err_msg=f"mean{i}")
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=5e-4,
                                   atol=1e-5, err_msg=f"var{i}")


@pytest.mark.parametrize("negative_scale", [False, True])
def test_pair3_grads_match_jax_and_autodiff(rng, negative_scale):
    x, layers, wvec = _setup(rng, negative_scale)
    xt = torch.from_numpy(x).requires_grad_(True)
    tl = _torch_layers(layers)
    pooled, _ = sa_train_pair3(xt, tl, EPS)
    (torch.sin(pooled) * torch.from_numpy(wvec)).sum().backward()
    _assert_grads(tl, _jax_grads(x, layers, wvec), "vs jax pair3")

    # Autodiff of the port's plain reference on the same rows (b, s, k).
    rl = _torch_layers(layers)
    rows = torch.from_numpy(x).permute(0, 2, 3, 1).reshape(-1, C0)
    rp, _ = sa_train_reference(rows, rl, K, EPS)
    (torch.sin(rp.reshape(B, S, -1)) * torch.from_numpy(wvec)).sum() \
        .backward()
    _assert_grads(tl, [SALayerParams(*(t.grad.numpy() for t in lp))
                       for lp in rl], "vs autodiff")

    # Input cotangent is zero by contract (sa_pair.py:67-68).
    assert xt.grad is not None
    assert torch.count_nonzero(xt.grad) == 0


def test_sa_eval_reference_matches_jax(rng):
    # Same op chain as the JAX function; only the matmul's summation order
    # differs, hence rtol 1e-5 rather than equality.
    x, layers, _ = _setup(rng, negative_scale=True)
    rows = x.transpose(0, 2, 3, 1).reshape(-1, C0)
    running = [(rng.normal(size=(w,)).astype(np.float32),
                rng.uniform(0.5, 2.0, size=(w,)).astype(np.float32))
               for w in WIDTHS]
    jp = jax_sa_eval_reference(jnp.asarray(rows), layers,
                               [tuple(map(jnp.asarray, r)) for r in running],
                               K, EPS)
    with torch.no_grad():
        tp = sa_eval_reference(torch.from_numpy(rows), _torch_layers(layers),
                               [tuple(map(torch.from_numpy, r))
                                for r in running], K, EPS)
    assert tuple(tp.shape) == jp.shape == (B * S, WIDTHS[-1])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)


def _pair_grads(x, layers, wvec, slim):
    xt = torch.from_numpy(x).requires_grad_(True)
    tl = _torch_layers(layers)
    pooled, _ = sa_train_pair(xt, tl, EPS, slim=slim)
    (torch.sin(pooled) * torch.from_numpy(wvec)).sum().backward()
    return xt, tl


@pytest.mark.parametrize("negative_scale", [False, True])
def test_pair_grads_match_jax_and_autodiff(rng, negative_scale):
    """The non-slim backward (B6 + layer 1 from third-order moments)."""
    x, layers, wvec = _setup(rng, negative_scale)
    xt, tl = _pair_grads(x, layers, wvec, slim=False)
    _assert_grads(tl, _jax_grads(x, layers, wvec, slim=False), "vs jax pair")
    rl = _torch_layers(layers)
    rows = torch.from_numpy(x).permute(0, 2, 3, 1).reshape(-1, C0)
    rp, _ = sa_train_reference(rows, rl, K, EPS)
    (torch.sin(rp.reshape(B, S, -1)) * torch.from_numpy(wvec)).sum() \
        .backward()
    _assert_grads(tl, [SALayerParams(*(t.grad.numpy() for t in lp))
                       for lp in rl], "vs autodiff")
    assert torch.count_nonzero(xt.grad) == 0


def test_pair_and_pair3_backwards_agree(rng):
    """Same forward and pool routing, two backwards: the layer-1 algebra
    through third-order moments equals the direct dy1 contraction up to
    f32 round-off."""
    x, layers, wvec = _setup(rng, negative_scale=True)
    _, full = _pair_grads(x, layers, wvec, slim=False)
    _, slim = _pair_grads(x, layers, wvec, slim=True)
    for i, (a, b) in enumerate(zip(full, slim)):
        for name in ("kernel", "scale", "shift"):
            g, r = getattr(a, name).grad, getattr(b, name).grad
            sc = max(1.0, float(r.abs().max()))
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * sc,
                                       msg=f"layer{i} {name}")


def test_pair_pool_ties_route_to_first_index(rng):
    """Duplicated neighbourhood halves: pair/pair3 route each pooled
    cotangent to the first row of the tie (not split evenly, as hybrid
    does), as JAX's pair path does."""
    half = rng.normal(size=(2, C0, S, K // 2)).astype(np.float32)
    x = np.concatenate([half, half], axis=3)
    layers = tuple(make_layers(rng, WIDTHS, C0))
    wvec = rng.normal(size=(WIDTHS[-1],)).astype(np.float32)
    for slim in (False, True):
        _, tl = _pair_grads(x, layers, wvec, slim)
        _assert_grads(tl, _jax_grads(x, layers, wvec, slim=slim),
                      f"ties slim={slim}")
