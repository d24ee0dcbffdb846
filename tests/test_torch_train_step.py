"""Six steps of the port's Trainer (CPU: the kernels' plain twins) against
six steps of the JAX package's Trainer (``sa_impl="reference"``), from
the same weights, on the same points, with the same circle permutations.
``steps_per_epoch=1`` puts the LR drop at step 4 inside the run.

Bars are those of tests/test_torch_parity.py:478-545: loss trajectory at
rtol 2e-3; final parameters (entries whose step-0 gradient is well above
the frameworks' agreed noise floor; BN-absorbed biases skipped — their
gradient is mathematically zero and Adam random-walks the noise) at
atol 3e-3 of the parameter scale; BN running means at rtol 2e-3 /
atol 3e-3 sigma and variances at rtol 3e-3. The same holds for three
steps with the kernel-backed SA paths ``hybrid2`` and ``pair`` on both
sides, and for six steps of the port's ``pallas`` path (kernel B9's
twins) against JAX's ``reference``, whose semantics define B9 (JAX runs
its pallas stage only on a TPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu.config import Config as JaxConfig
from facl_tpu.config import GroupingConfig as JaxGroupingConfig
from facl_tpu.train import Trainer as JaxTrainer
from facl_tpu_torch.config import Config
from facl_tpu_torch.convert import from_jax
from facl_tpu_torch.train import Trainer

WIDTHS_SA, WIDTHS_S2 = (8, 8, 16), (16, 32)
G, B, S, K, D, N = 4, 3, 8, 8, 12, 48
STEPS = 6


def _cfg(cls, gcls, **model_kw):
    cfg = cls()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, sa_widths=WIDTHS_SA, stage2_widths=WIDTHS_S2,
            fc_hidden=24, embed_dim=D, num_prototypes=6, num_crops=G,
            **model_kw),
        grouping=gcls(num_centroids=S, knn_k=K, radius_sq=10.0),
        train=dataclasses.replace(cfg.train, batch_size=B))


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _run_both(rng, steps, sa_impl, port_impl=None):
    """``steps`` steps of the JAX Trainer (``sa_impl`` as given, else
    "reference") and of the port's (its default, else ``port_impl`` or
    ``sa_impl``) from the same weights, points and permutations. Returns
    (JAX losses, JAX final state, port losses, port state, the port's
    step-0 gradients)."""
    batches = [rng.normal(size=(G, B, N, 4)).astype(np.float32)
               for _ in range(steps)]
    keys = [jax.random.fold_in(jax.random.PRNGKey(11), i)
            for i in range(steps)]
    # The JAX step draws its circle permutation from split(key)[1].
    perms = [np.asarray(jax.random.permutation(jax.random.split(k)[1], G))
             for k in keys]

    jt = JaxTrainer(_cfg(JaxConfig, JaxGroupingConfig,
                         sa_impl=sa_impl or "reference"), steps_per_epoch=1)
    jstate = jt.init_state(jax.random.PRNGKey(0), jnp.asarray(batches[0]))
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    stats0 = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    jlosses = []
    for i in range(steps):
        jstate, m = jt.step_fn(jstate, jnp.asarray(batches[i]), keys[i],
                               jnp.asarray(0, jnp.int32))
        jlosses.append(float(m["loss"]))

    from facl_tpu_torch.config import GroupingConfig
    port_impl = port_impl or sa_impl
    kw = {"sa_impl": port_impl} if port_impl else {}
    tt = Trainer(_cfg(Config, GroupingConfig, **kw), steps_per_epoch=1,
                 device="cpu")
    tstate = tt.init_state(0)
    tstate.model.load_state_dict(from_jax(params0, stats0))
    tlosses, grads0 = [], {}
    for i in range(steps):
        tstate, m = tt.step_fn(tstate, torch.from_numpy(batches[i]),
                               perm=torch.tensor(perms[i]))
        tlosses.append(float(m["loss"]))
        if i == 0:
            grads0 = {n: p.grad.clone() for n, p in
                      tstate.model.named_parameters() if p.grad is not None}
    return jlosses, jstate, tlosses, tstate, grads0


def _assert_states(jstate, tstate, grads0):
    tparams = from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                       {})
    live = dict(tstate.model.named_parameters())
    absorbed = {"sa_stage.bias_0", "sa_stage.bias_1", "sa_stage.bias_2",
                "stage2_mlp.dense_0.bias", "stage2_mlp.dense_1.bias",
                "head.Dense_0.bias"}
    total = checked = 0
    for name, jp in tparams.items():
        if name in absorbed or name not in grads0:   # mapping: no grad
            continue
        g0 = grads0[name].abs()
        mask = (g0 > 1e-3 * max(float(g0.max()), 1e-12)).numpy()
        tp = live[name].detach().numpy()
        scale = max(np.abs(jp.numpy()).max(), np.abs(tp).max(), 1e-8)
        total += mask.size
        checked += int(mask.sum())
        np.testing.assert_allclose(tp[mask] / scale, jp.numpy()[mask] / scale,
                                   atol=3e-3, err_msg=name)
    assert checked > 0.5 * total, (checked, total)

    buffers = dict(tstate.model.named_buffers())
    for path, jv in _leaves(jstate.batch_stats):
        name = ".".join(path)
        tv = buffers[name].numpy()
        if path[-1].startswith("mean"):
            var = np.asarray(dict(_leaves(jstate.batch_stats))[
                path[:-1] + (path[-1].replace("mean", "var"),)])
            sigma = float(np.sqrt(var.mean()))
            np.testing.assert_allclose(tv, jv, rtol=2e-3, atol=3e-3 * sigma,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(tv, jv, rtol=3e-3, atol=1e-6,
                                       err_msg=name)


def test_six_steps_match_jax_trainer(rng):
    jlosses, jstate, tlosses, tstate, grads0 = _run_both(rng, STEPS, None)
    assert tstate.step == STEPS
    assert tstate.scheduler.get_last_lr()[0] == 3e-4 * 0.7
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-3)
    _assert_states(jstate, tstate, grads0)


@pytest.mark.parametrize("sa_impl", ["hybrid2", "pair"])
def test_steps_match_jax_trainer_with_impl(rng, sa_impl):
    jlosses, jstate, tlosses, tstate, grads0 = _run_both(rng, 3, sa_impl)
    assert tstate.model.cfg.sa_impl == sa_impl
    assert tstate.model.cfg.channels_first == (sa_impl == "pair")
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-3)
    _assert_states(jstate, tstate, grads0)


def test_six_pallas_steps_match_jax_reference(rng):
    jlosses, jstate, tlosses, tstate, grads0 = _run_both(rng, STEPS, None,
                                                         "pallas")
    assert tstate.model.cfg.sa_impl == "pallas"
    assert tstate.model.cfg.channels_first is False
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-3)
    _assert_states(jstate, tstate, grads0)


@pytest.mark.parametrize("select_impl,gather_impl,called", [
    ("auto", "auto", "select_gather_knn_ball"),
    ("pallas", "pallas", "select_gather_knn_ball"),
    ("pallas", "xla", "select_knn_ball"),
    ("xla", "pallas", "gather_rows_vjp"),
    ("xla", "xla", "knn_ball_plain")])
def test_grouping_fn_honours_select_and_gather_impl(rng, monkeypatch,
                                                    select_impl, gather_impl,
                                                    called):
    """make_grouping_fn routes on the config's select_impl / gather_impl
    (facl_tpu/train/trainer.py:83-87): each route calls its own function,
    and every route gives the same neighbourhood sets."""
    from facl_tpu_torch.config import GroupingConfig
    from facl_tpu_torch.ops import grouping
    from facl_tpu_torch.train.trainer import make_grouping_fn
    names = ("select_gather_knn_ball", "select_knn_ball", "gather_rows_vjp",
             "knn_ball_plain")
    calls = dict.fromkeys(names, 0)

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    for n in names:
        monkeypatch.setattr(grouping, n, spy(n, getattr(grouping, n)))
    pts = torch.from_numpy(rng.uniform(-0.5, 0.5, size=(2, 3, N, 4))
                           .astype(np.float32))
    fn = make_grouping_fn(GroupingConfig(num_centroids=S, knn_k=K,
                                         radius_sq=0.2,
                                         select_impl=select_impl,
                                         gather_impl=gather_impl), "bskc")
    neigh, cent = fn(pts)
    assert calls[called] == 1
    # xla select + pallas gather is the one route of two spied calls.
    assert sum(calls.values()) == (2 if called == "gather_rows_vjp" else 1)
    ref, rc = make_grouping_fn(GroupingConfig(num_centroids=S, knn_k=K,
                                              radius_sq=0.2), "bskc")(pts)
    assert torch.equal(cent, rc)
    assert torch.equal(neigh.sort(3).values, ref.sort(3).values)
