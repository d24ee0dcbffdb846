"""Kernel B9 (the generic fused SA of ``sa_impl="pallas"``) of the PyTorch
port — its sweeps' plain twins on the CPU — against the JAX package's TPU
kernels in interpret mode (facl_tpu/ops/pallas/sa_kernel.py via
facl_tpu/ops/fused_sa.py::sa_train_fused). Bars are those of
tests/test_fused_sa.py:44-50, 101-107 and 128-131: the two sum in other
orders, so the forward is held at rtol/atol 2e-5 (means 1e-5, variances
1e-4 / 1e-5), the loss and gradients at rtol 1e-3 / atol 1e-4, the
duplicated-row tie case at rtol 1e-4 / atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu.ops.fused_sa import SALayerParams as JaxLayer
from facl_tpu.ops.fused_sa import sa_train_fused as jax_sa_train_fused
from facl_tpu.ops.pallas.sa_kernel import sa_train_forward_unified as \
    jax_forward_unified
from facl_tpu_torch.ops.fused_sa import SALayerParams, sa_train_fused, \
    sa_train_reference
from facl_tpu_torch.ops.sa_kernel import sa_train_forward_unified


def _layers(rng, widths, c0=4):
    """The same weights for both packages (tests/test_fused_sa.py)."""
    out, cin = [], c0
    for w in widths:
        out.append([rng.normal(size=(cin, w)).astype(np.float32) * 0.5,
                    rng.normal(size=(w,)).astype(np.float32) * 0.1,
                    1.0 + 0.1 * rng.normal(size=(w,)).astype(np.float32),
                    0.1 * rng.normal(size=(w,)).astype(np.float32)])
        cin = w
    jl = tuple(JaxLayer(*(jnp.asarray(a) for a in lp)) for lp in out)
    tl = [SALayerParams(*(torch.from_numpy(a).requires_grad_(True)
                          for a in lp)) for lp in out]
    return jl, tl


def test_forward_matches_tpu_kernel(rng):
    R, K = 256, 8
    x = rng.normal(size=(R, 4)).astype(np.float32)
    jl, tl = _layers(rng, (8, 16, 32))
    jp, jstats, jpacked = jax_forward_unified(jnp.asarray(x), jl, K,
                                              interpret=True)
    with torch.no_grad():
        tp, tstats, tpacked = sa_train_forward_unified(torch.from_numpy(x),
                                                       tl, K)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=2e-5,
                               atol=2e-5)
    for l, ((jm, jv), (tm, tv)) in enumerate(zip(jstats, tstats)):
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-4,
                                   atol=1e-5)
        w = tm.shape[0]       # packed rows past a layer's width differ
        np.testing.assert_allclose(tpacked[l, :, :w].numpy(),
                                   np.asarray(jpacked)[l, :, :w],
                                   rtol=1e-4, atol=1e-5)


def _value_and_grads_both(x, jl, tl, K, weight):
    def jloss(x, layers):
        pooled, _ = jax_sa_train_fused(x, layers, K, 1e-5, jnp.float32,
                                       True)
        return jnp.sum(weight(pooled, jnp))

    jv, (jgx, jgl) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jl)
    xt = torch.from_numpy(x).requires_grad_(True)
    pooled, _ = sa_train_fused(xt, tl, K)
    tv = weight(pooled, torch).sum()
    tv.backward()
    jg = [jgx] + [t for lp in jgl for t in lp]
    tg = [xt.grad] + [t.grad for lp in tl for t in lp]
    return float(jv), float(tv.detach()), jg, tg


def test_sa_train_fused_value_and_grads_match_tpu_kernel(rng):
    R, K = 128, 8
    x = rng.normal(size=(R, 4)).astype(np.float32)
    jl, tl = _layers(rng, (8, 16))
    jv, tv, jg, tg = _value_and_grads_both(x, jl, tl, K,
                                           lambda p, m: p ** 2)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3,
                                   atol=1e-4)


def test_tie_gradients_match_tpu_kernel(rng):
    """Duplicated rows inside each group tie the max; the cotangent is split
    evenly among the ties, as JAX's."""
    R, K = 64, 8
    x = rng.normal(size=(R, 4)).astype(np.float32)
    x[1::2] = x[::2]
    jl, tl = _layers(rng, (8,))
    _, _, jg, tg = _value_and_grads_both(x, jl, tl, K,
                                         lambda p, m: p * 3.0)
    np.testing.assert_allclose(tg[0].numpy(), np.asarray(jg[0]), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("K,widths", [(128, (16, 8, 24, 32)), (48, (32,))])
def test_sa_train_fused_matches_autograd(rng, K, widths):
    """Pools spanning 128 rows and four layers, and a pool that leaves the
    kernel's 64-row tiles partly empty: the sweeps' twins against torch
    autograd of the plain reference, at the same bars."""
    x = rng.normal(size=(4 * K, 3)).astype(np.float32)
    _, tl = _layers(rng, widths, c0=3)
    xt = torch.from_numpy(x).requires_grad_(True)
    wv = torch.from_numpy(rng.normal(size=(widths[-1],)).astype(np.float32))
    pooled, stats = sa_train_fused(xt, tl, K)
    (torch.sin(pooled) * wv).sum().backward()
    got = [xt.grad] + [t.grad for lp in tl for t in lp]
    xr = torch.from_numpy(x).requires_grad_(True)
    lr = [SALayerParams(*(t.detach().clone().requires_grad_(True)
                          for t in lp)) for lp in tl]
    rpooled, rstats = sa_train_reference(xr, lr, K)
    (torch.sin(rpooled) * wv).sum().backward()
    ref = [xr.grad] + [t.grad for lp in lr for t in lp]
    torch.testing.assert_close(pooled, rpooled, rtol=2e-5, atol=2e-5)
    for (m, v), (rm, rv) in zip(stats, rstats):
        torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(v, rv, rtol=1e-4, atol=1e-5)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4)


def test_without_input_grad_dx_is_zero(rng):
    x = torch.from_numpy(rng.normal(size=(64, 4)).astype(np.float32)) \
        .requires_grad_(True)
    _, tl = _layers(rng, (8, 16))
    pooled, _ = sa_train_fused(x, tl, 8, need_dx=False)
    pooled.sum().backward()
    assert torch.count_nonzero(x.grad) == 0
    assert all(t.grad is not None for lp in tl for t in lp)


@pytest.mark.parametrize("impl", ["auto", "pallas", "reference"])
def test_sa_train_dispatch(rng, impl):
    """sa_train(impl=...) (facl_tpu/ops/fused_sa.py:163-176): "auto" and
    "pallas" take B9, "reference" the plain math; all agree."""
    from facl_tpu_torch.ops.fused_sa import sa_train
    x = torch.from_numpy(rng.normal(size=(64, 4)).astype(np.float32))
    _, tl = _layers(rng, (8, 16))
    with torch.no_grad():
        pooled, stats = sa_train(x, tl, 8, impl=impl)
        ref, rstats = sa_train_reference(x, tl, 8)
    torch.testing.assert_close(pooled, ref, rtol=2e-5, atol=2e-5)
    for (m, v), (rm, rv) in zip(stats, rstats):
        torch.testing.assert_close(m, rm, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(v, rv, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="unknown SA impl"):
        sa_train(x, tl, 8, impl="nope")
