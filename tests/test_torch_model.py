"""The port's PointNetPlus (weights from ``convert.from_jax``) against the
JAX PointNetPlus, in train and eval mode, and the BatchNorm running
statistics after one train forward (the shared head updated twice).

Bars: rtol 2e-3 / atol 1e-3 on the outputs, as tests/test_torch_parity.py
:156-162 (f32 accumulation noise through the BN chains reaches ~6e-4 on
near-zero outputs); running statistics at rtol 1e-4 / atol 1e-5 (one
momentum update of batch moments that agree to float round-off).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu.config import ModelConfig as JaxModelConfig
from facl_tpu.models import PointNetPlus as JaxPointNetPlus
from facl_tpu.models.pointnet import resolve_model_config as jax_resolve
from facl_tpu.ops.grouping import group_points as jax_group_points
from facl_tpu_torch.config import ModelConfig
from facl_tpu_torch.convert import from_jax
from facl_tpu_torch.models import PointNetPlus, resolve_model_config

KW = dict(sa_widths=(8, 8, 16), stage2_widths=(16, 32), fc_hidden=24,
          embed_dim=12, num_prototypes=6, num_crops=3)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield ".".join(prefix + (k,)), np.asarray(v)


@pytest.fixture
def built(rng):
    G, B, S, K = 3, 2, 8, 8
    pts = jnp.asarray(rng.normal(size=(G * B, 48, 4)).astype(np.float32))
    neigh, cent = jax_group_points(pts, S, K, radius_sq=10.0)
    jmodel = JaxPointNetPlus(JaxModelConfig(sa_impl="reference",
                                            channels_first=False, **KW))
    variables = jmodel.init(jax.random.PRNGKey(0), neigh, cent, train=False)
    tmodel = PointNetPlus(resolve_model_config(ModelConfig(sa_impl="pair3",
                                                           **KW)))
    tmodel.load_state_dict(from_jax(variables["params"],
                                    variables["batch_stats"]))
    tneigh = torch.from_numpy(np.array(neigh)).permute(0, 3, 1, 2)
    return jmodel, variables, tmodel, (neigh, cent), \
        (tneigh.contiguous(), torch.from_numpy(np.array(cent)))


def _assert_outputs(t_out, j_out):
    for name, t, j in zip(("x", "code", "x_nor", "x_global"), t_out, j_out):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                                   rtol=2e-3, atol=1e-3, err_msg=name)


def test_train_forward_and_running_stats(built):
    jmodel, variables, tmodel, jin, tin = built
    j_out, mutated = jmodel.apply(variables, *jin, train=True,
                                  mutable=["batch_stats"])
    tmodel.train()
    t_out = tmodel(*tin)
    _assert_outputs(t_out, j_out)
    buffers = dict(tmodel.named_buffers())
    names = dict(_leaves(mutated["batch_stats"]))
    assert set(names) == set(buffers)
    for name, j in names.items():
        np.testing.assert_allclose(buffers[name].numpy(), j, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_eval_forward(built):
    jmodel, variables, tmodel, jin, tin = built
    # Non-trivial running statistics: one train step's update on both.
    _, mutated = jmodel.apply(variables, *jin, train=True,
                              mutable=["batch_stats"])
    variables = {"params": variables["params"],
                 "batch_stats": mutated["batch_stats"]}
    tmodel.load_state_dict(from_jax(variables["params"],
                                    variables["batch_stats"]))
    tmodel.eval()
    with torch.no_grad():
        t_out = tmodel(*tin)
    _assert_outputs(t_out, jmodel.apply(variables, *jin, train=False))


def test_fine_variant_grouping():
    from facl_tpu_torch.config import Config
    from facl_tpu_torch.models import resolve_model
    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                name="pointnet_plus_fine"))
    model, g = resolve_model(cfg, torch.Generator().manual_seed(0))
    assert (g.num_centroids, g.knn_k) == (32, 128)
    assert model.cfg.sa_impl == "pair3" and model.cfg.channels_first


def test_auto_at_small_widths_matches_jax_auto(rng):
    """``sa_impl="auto"`` at widths the sweep kernels do not take resolves
    to "reference" (channels-last) in the port, as the JAX package's
    "auto" does off the TPU: same weights, same train forward and running
    statistics."""
    G, B, S, K = 3, 2, 8, 8
    pts = jnp.asarray(rng.normal(size=(G * B, 48, 4)).astype(np.float32))
    neigh, cent = jax_group_points(pts, S, K, radius_sq=10.0)
    jcfg = jax_resolve(JaxModelConfig(sa_impl="auto", **KW))
    assert (jcfg.sa_impl, jcfg.channels_first) == ("reference", False)
    jmodel = JaxPointNetPlus(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(1), neigh, cent, train=False)
    tmodel = PointNetPlus(ModelConfig(**KW))
    assert (tmodel.cfg.sa_impl, tmodel.cfg.channels_first) == \
        ("reference", False)
    tmodel.load_state_dict(from_jax(variables["params"],
                                    variables["batch_stats"]))
    j_out, mutated = jmodel.apply(variables, neigh, cent, train=True,
                                  mutable=["batch_stats"])
    t_out = tmodel.train()(torch.from_numpy(np.array(neigh)),
                           torch.from_numpy(np.array(cent)))
    _assert_outputs(t_out, j_out)
    buffers = dict(tmodel.named_buffers())
    for name, j in _leaves(mutated["batch_stats"]):
        np.testing.assert_allclose(buffers[name].numpy(), j, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
