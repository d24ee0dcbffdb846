"""The port's training step at ``compute_dtype="bfloat16"`` against the JAX
package's: one step of each Trainer from the same weights (carried by
``convert.from_jax``), points and circle permutation, for
``sa_impl="reference"``, ``"pair3"``, ``"pair"``, ``"hybrid2"`` and
``"hybrid"`` (the JAX kernels in interpret mode, the port's bf16 sweep
twins); the shipped training configs, loaded as they are, stepping the
port's Trainer at full width, with the config's sa_impl and with the
impls of the bf16 sweep kernels B2-B8; and the bf16 GEMM flag. The
pallas, covar and analytic steps at bf16 are in
tests/test_torch_bf16_fused.py (through the helpers here).

Tolerances (the JAX package's bf16 bars, tests/test_covar_bn.py:38-39):
the loss at rtol 5e-2; the BatchNorm running statistics after the step
at rtol = atol = 5e-2; and the first Adam step, which moves every entry
by +-lr where its gradient is well above Adam's eps: on the entries whose
port gradient is at least 5% of its tensor's largest, the port's update
has the JAX update's sign on at least 99% of them (bf16 rounding moves a
gradient by ~1% of its scale, so only entries near zero may flip).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu.config import Config as JaxConfig
from facl_tpu.config import GroupingConfig as JaxGroupingConfig
from facl_tpu.train import Trainer as JaxTrainer
from facl_tpu_torch.config import Config, GroupingConfig
from facl_tpu_torch.convert import from_jax
from facl_tpu_torch.train import Trainer

ROOT = Path(__file__).resolve().parents[1]
WIDTHS_SA, WIDTHS_S2 = (8, 8, 16), (16, 32)
G, B, S, K, D, N = 4, 3, 8, 8, 12, 48
ABSORBED = {"sa_stage.bias_0", "sa_stage.bias_1", "sa_stage.bias_2",
            "stage2_mlp.dense_0.bias", "stage2_mlp.dense_1.bias",
            "head.Dense_0.bias"}


def _cfg(cls, gcls, sa_impl):
    cfg = cls()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, sa_widths=WIDTHS_SA, stage2_widths=WIDTHS_S2,
            fc_hidden=24, embed_dim=D, num_prototypes=6, num_crops=G,
            compute_dtype="bfloat16", sa_impl=sa_impl),
        grouping=gcls(num_centroids=S, knn_k=K, radius_sq=10.0),
        train=dataclasses.replace(cfg.train, batch_size=B))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def step_vs_jax(rng, sa_impl, jax_impl=None):
    """One bf16 step of the port's Trainer with ``sa_impl`` against one of
    JAX's with ``jax_impl`` (default: the same impl), at the bars of the
    module docstring."""
    points = rng.normal(size=(G, B, N, 4)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    perm = np.asarray(jax.random.permutation(jax.random.split(key)[1], G))

    jt = JaxTrainer(_cfg(JaxConfig, JaxGroupingConfig, jax_impl or sa_impl),
                    steps_per_epoch=1)
    jstate = jt.init_state(jax.random.PRNGKey(0), jnp.asarray(points))
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    stats0 = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    jstate, jm = jt.step_fn(jstate, jnp.asarray(points), key,
                            jnp.asarray(0, jnp.int32))

    tt = Trainer(_cfg(Config, GroupingConfig, sa_impl), steps_per_epoch=1,
                 device="cpu")
    tstate = tt.init_state(0)
    tstate.model.load_state_dict(from_jax(params0, stats0))
    assert tstate.model.cfg.sa_impl == sa_impl
    assert tstate.model.dtype == torch.bfloat16
    before = {n: p.detach().clone()
              for n, p in tstate.model.named_parameters()}
    tstate, tm = tt.step_fn(tstate, torch.from_numpy(points),
                            perm=torch.tensor(perm))
    assert tm["loss"].dtype == torch.float32
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=5e-2)

    jparams = from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), {})
    lr = 3e-4
    checked = agree = 0
    for name, p in tstate.model.named_parameters():
        assert p.dtype == torch.float32, name
        if name in ABSORBED or p.grad is None:
            continue
        g = p.grad.abs()
        mask = g >= 0.05 * float(g.max())
        dt = torch.sign(p.detach() - before[name])[mask]
        dj = torch.sign(jparams[name] - before[name])[mask]
        assert bool(((p.detach() - before[name]).abs()
                     <= lr * 1.001).all()), name
        checked += int(mask.sum())
        agree += int((dt == dj).sum())
    assert checked > 0 and agree >= 0.99 * checked, (agree, checked)

    buffers = dict(tstate.model.named_buffers())
    for path, jv in _leaves(jstate.batch_stats):
        name = ".".join(path)
        assert buffers[name].dtype == torch.float32, name
        np.testing.assert_allclose(buffers[name].numpy(), jv, rtol=5e-2,
                                   atol=5e-2, err_msg=name)


@pytest.mark.parametrize("sa_impl", ["reference", "pair3", "pair", "hybrid2",
                                     "hybrid"])
def test_bf16_step_matches_jax_trainer(rng, sa_impl):
    step_vs_jax(rng, sa_impl)


def shipped_step(rng, name, sa_impl):
    """The shipped config ``name`` with ``sa_impl`` (None: as shipped): the
    port's Trainer builds and takes one full-width step on the CPU at
    batch 2, finite, with f32 gradients."""
    cfg = Config.from_json((ROOT / "configs" / name).read_text())
    assert cfg.model.compute_dtype == "bfloat16"
    assert cfg.model.sa_impl == "reference"
    if sa_impl is not None:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    sa_impl=sa_impl))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=2))
    tr = Trainer(cfg, steps_per_epoch=10, device="cpu")
    assert tr.cfg.model.sa_impl == {None: "reference", "auto": "pair3"}.get(
        sa_impl, sa_impl)
    state = tr.init_state(0)
    pts = torch.from_numpy(rng.normal(
        size=(cfg.model.num_crops, 2, cfg.data.num_points,
              cfg.model.in_features)).astype(np.float32))
    state, m = tr.step_fn(state, pts, generator=torch.Generator()
                          .manual_seed(0))
    assert state.step == 1 and bool(torch.isfinite(m["loss"]))
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    assert grads and all(g.dtype == torch.float32 and
                         bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("sa_impl", [None, "auto", "pair", "hybrid2",
                                     "hybrid"])
@pytest.mark.parametrize("name", ["motion_ntu60_xview.json",
                                  "appearance_ntu60_xsub.json"])
def test_shipped_bf16_config_steps_at_full_width(rng, name, sa_impl):
    """The shipped config as it is (bf16, sa_impl "reference"), and with
    sa_impl forced to "auto" (bf16 pair3 at these widths), "pair",
    "hybrid2" or "hybrid" (pallas, covar and analytic:
    tests/test_torch_bf16_fused.py)."""
    shipped_step(rng, name, sa_impl)


def test_bf16_reduced_precision_reduction_is_off_after_import():
    code = ("import torch, facl_tpu_torch; "
            "print(torch.backends.cuda.matmul."
            "allow_bf16_reduced_precision_reduction)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "False"
