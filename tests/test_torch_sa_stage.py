"""The port's SetAbstractionStage, for each ``impl``, against the JAX
package's SetAbstractionStage with the same impl (its Pallas kernels in
interpret mode): loss, ``batch_stats`` after one train forward, and the
parameter gradients; the ``input_grad`` contract; and
``resolve_model_config``'s impl rules.

Weights come from the JAX module through ``convert.from_jax`` (the stage
keeps the JAX parameter names, so one state_dict serves every impl).
Bars follow tests/test_sa_pfwd.py / test_sa_hybrid.py: the kernel paths
sum moments in another order than the reference, so the loss is held at
rtol 1e-4, batch statistics at rtol 5e-4 / atol 1e-5, gradients at rtol
2e-3 / atol 2e-3 x their scale (the Dense biases, whose exact gradient is
zero under BatchNorm, are skipped as the JAX tests skip them).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu.models.sa_stage import SetAbstractionStage as JaxStage
from facl_tpu_torch.config import ModelConfig
from facl_tpu_torch.convert import from_jax
from facl_tpu_torch.models import resolve_model_config
from facl_tpu_torch.models.sa_stage import SetAbstractionStage

WIDTHS = (8, 8, 16)


def _jax_run(impl, x, **kw):
    stage = JaxStage(WIDTHS, impl=impl, **kw)
    variables = stage.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)

    def loss(v, x):
        out, mut = stage.apply(v, x, train=True, mutable=["batch_stats"])
        return jnp.sum(out ** 2), mut["batch_stats"]

    (lo, bs), (g, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                           has_aux=True)(variables,
                                                         jnp.asarray(x))
    return variables, float(lo), bs, g["params"], gx


def _torch_stage(variables, **kw):
    st = SetAbstractionStage(4, WIDTHS, **kw)
    st.load_state_dict(from_jax(variables["params"],
                                variables["batch_stats"]))
    return st.train()


@pytest.mark.parametrize("impl,cf", [
    ("reference", True), ("covar", True), ("analytic", True),
    ("hybrid", True), ("hybrid2", True), ("pair", True), ("pair3", True),
    ("pair", False), ("hybrid2", False)])
def test_stage_matches_jax(rng, impl, cf):
    x = rng.normal(size=(4, 6, 8, 4)).astype(np.float32)     # (B, S, K, C)
    variables, jloss, jbs, jg, jgx = _jax_run(impl, x)
    st = _torch_stage(variables, impl=impl, channels_first=cf)
    xt = torch.from_numpy(x)
    xt = (xt.permute(0, 3, 1, 2).contiguous() if cf else xt) \
        .requires_grad_(True)
    loss = (st(xt) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-4)
    buffers = dict(st.named_buffers())
    for name, jv in jbs.items():
        np.testing.assert_allclose(buffers[name].numpy(), np.asarray(jv),
                                   rtol=5e-4, atol=1e-5, err_msg=name)
    params = dict(st.named_parameters())
    for name, jv in jg.items():
        if name.startswith("bias"):
            continue
        r = np.asarray(jv)
        sc = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(params[name].grad.numpy(), r, rtol=2e-3,
                                   atol=2e-3 * sc, err_msg=name)
    if impl == "analytic":        # the input gradient, in the input layout
        gx = xt.grad.permute(0, 2, 3, 1) if cf else xt.grad
        sc = max(1.0, float(np.abs(np.asarray(jgx)).max()))
        np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=2e-3,
                                   atol=2e-3 * sc)
    elif impl not in ("reference", "covar"):
        assert torch.count_nonzero(xt.grad) == 0


@pytest.mark.parametrize("impl", ["hybrid", "hybrid2", "pair", "pair3"])
def test_stage_rejects_input_grad(impl):
    st = SetAbstractionStage(4, (4, 4, 8), impl=impl, input_grad=True)
    with pytest.raises(ValueError, match="input cotangent"):
        st.train()(torch.zeros(2, 4, 2, 4))
    st.eval()(torch.zeros(2, 4, 2, 4))        # eval has no cotangent


def test_stage_input_grad_with_analytic():
    st = SetAbstractionStage(4, (4, 4, 8), impl="analytic", input_grad=True)
    x = torch.randn(2, 4, 2, 4, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    st.train()(x).sum().backward()
    assert torch.count_nonzero(x.grad) > 0


def test_resolve_model_config_impls():
    cfg = ModelConfig()
    assert resolve_model_config(cfg).sa_impl == "pair3"
    assert resolve_model_config(cfg).channels_first is True
    for impl in ("reference", "covar", "analytic", "hybrid", "hybrid2"):
        r = resolve_model_config(dataclasses.replace(cfg, sa_impl=impl))
        assert (r.sa_impl, r.channels_first) == (impl, False)
    r = resolve_model_config(dataclasses.replace(cfg, sa_impl="pair"))
    assert (r.sa_impl, r.channels_first) == ("pair", True)
    r = resolve_model_config(dataclasses.replace(cfg, sa_impl="hybrid2",
                                                 channels_first=True))
    assert r.channels_first is True                  # explicit: honoured
    r = resolve_model_config(dataclasses.replace(cfg, sa_impl="pallas"))
    assert (r.sa_impl, r.channels_first) == ("pallas", False)
    with pytest.raises(ValueError, match="unknown sa_impl"):
        resolve_model_config(dataclasses.replace(cfg, sa_impl="nope"))


@pytest.mark.parametrize("widths,in_features,impl,cf", [
    ((64, 64, 256), 4, "pair3", True),
    ((64, 64, 256), 7, "pair3", True),
    ((8, 8, 16), 4, "reference", False),
    ((16, 16, 32), 4, "reference", False),
    ((64, 64, 256), 8, "reference", False),
    ((64, 64, 128), 4, "reference", False),
])
def test_resolve_auto_by_widths(widths, in_features, impl, cf):
    """``auto`` is pair3 only where the sweep kernels take the stage (SA
    widths TRUNK, at most 7 input channels), else the JAX package's
    off-TPU choice, reference; an explicit impl is kept at any width."""
    cfg = ModelConfig(sa_widths=widths, in_features=in_features)
    r = resolve_model_config(cfg)
    assert (r.sa_impl, r.channels_first) == (impl, cf)
    r = resolve_model_config(dataclasses.replace(cfg, sa_impl="pair3"))
    assert (r.sa_impl, r.channels_first) == ("pair3", True)


@pytest.mark.parametrize("cf", [False, True])
@pytest.mark.parametrize("input_grad", [False, True])
def test_pallas_stage_matches_jax_reference(rng, cf, input_grad):
    """The port's ``pallas`` stage (kernel B9's twins here) against the JAX
    stage with ``impl="reference"``, whose semantics define B9 (JAX runs
    its own pallas stage only on a TPU: sa_stage.py:137-139 compiles the
    kernel, no interpret mode). Bars as test_stage_matches_jax; with
    ``input_grad`` the input gradient at the analytic impl's bar, without
    it zeros."""
    x = rng.normal(size=(4, 6, 8, 4)).astype(np.float32)
    variables, jloss, jbs, jg, jgx = _jax_run("reference", x)
    st = _torch_stage(variables, impl="pallas", channels_first=cf,
                      input_grad=input_grad)
    xt = torch.from_numpy(x)
    xt = (xt.permute(0, 3, 1, 2).contiguous() if cf else xt) \
        .requires_grad_(True)
    loss = (st(xt) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-4)
    buffers = dict(st.named_buffers())
    for name, jv in jbs.items():
        np.testing.assert_allclose(buffers[name].numpy(), np.asarray(jv),
                                   rtol=5e-4, atol=1e-5, err_msg=name)
    params = dict(st.named_parameters())
    for name, jv in jg.items():
        if name.startswith("bias"):
            continue
        r = np.asarray(jv)
        sc = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(params[name].grad.numpy(), r, rtol=2e-3,
                                   atol=2e-3 * sc, err_msg=name)
    if input_grad:
        gx = xt.grad.permute(0, 2, 3, 1) if cf else xt.grad
        sc = max(1.0, float(np.abs(np.asarray(jgx)).max()))
        np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=2e-3,
                                   atol=2e-3 * sc)
    else:
        assert torch.count_nonzero(xt.grad) == 0


def test_from_jax_loads_into_pallas_stage(rng):
    """JAX variables of a ``pallas`` stage (initialised in eval mode, which
    runs no kernel) load into the port's ``pallas`` stage by name, and the
    two eval forwards agree."""
    x = rng.normal(size=(2, 4, 8, 4)).astype(np.float32)
    stage = JaxStage(WIDTHS, impl="pallas")
    variables = stage.init(jax.random.PRNGKey(3), jnp.asarray(x),
                           train=False)
    st = _torch_stage(variables, impl="pallas", channels_first=False)
    out = st.eval()(torch.from_numpy(x))
    ref = stage.apply(variables, jnp.asarray(x), train=False)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)
