"""The port's eval step and feature extraction against the JAX package's,
on the CPU, from weights and BatchNorm running statistics that real train
steps produced (JAX Trainer steps, carried by ``convert.from_jax``: fresh
statistics, mean 0 and var 1, would hide a stale-buffer bug), on the same
crops; a facl_tpu checkpoint carried the same way; and the approximate-kNN
grouping.

Tolerances: f32 outputs at rtol 1e-4 with atol 1e-4 of the tensor's
largest magnitude; bf16 at the JAX package's bf16 bar, rtol 5e-2 with
atol 5e-2 of the scale (tests/test_covar_bn.py:38-39); file names,
features_from_outputs and the grouping exact."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu.config import Config as JaxConfig
from facl_tpu.config import GroupingConfig as JaxGroupingConfig
from facl_tpu.ops import group_points as jax_group_points
from facl_tpu.ops.grouping import pairwise_sqdist
from facl_tpu.train import Trainer as JaxTrainer
from facl_tpu.train import restore_latest as jax_restore_latest
from facl_tpu.train import save_checkpoint as jax_save_checkpoint
from facl_tpu.train.extract import extract_features as jax_extract
from facl_tpu.train.extract import features_from_outputs as jax_fo
from facl_tpu.train.trainer import make_eval_step as jax_make_eval_step
from facl_tpu_torch.config import Config, GroupingConfig
from facl_tpu_torch.convert import from_jax
from facl_tpu_torch.ops.grouping import group_points
from facl_tpu_torch.train import Trainer, make_eval_step
from facl_tpu_torch.train.extract import extract_features, \
    features_from_outputs

WIDTHS_SA, WIDTHS_S2 = (8, 8, 16), (16, 32)
G, B, S, K, D, N = 4, 3, 8, 8, 12, 48
BARS = {"float32": 1e-4, "bfloat16": 5e-2}


def _cfg(cls, gcls, dtype="float32", sa_impl="reference"):
    cfg = cls()
    return cfg.replace(
        model=dataclasses.replace(
            cfg.model, sa_widths=WIDTHS_SA, stage2_widths=WIDTHS_S2,
            fc_hidden=24, embed_dim=D, num_prototypes=6, num_crops=G,
            compute_dtype=dtype, sa_impl=sa_impl),
        grouping=gcls(num_centroids=S, knn_k=K, radius_sq=0.5),
        train=dataclasses.replace(cfg.train, batch_size=B))


def _trained_jax(rng, dtype, steps=3):
    """A JAX Trainer after ``steps`` train steps: (trainer, state)."""
    jt = JaxTrainer(_cfg(JaxConfig, JaxGroupingConfig, dtype),
                    steps_per_epoch=1)
    pts = rng.uniform(-0.6, 0.6, size=(G, B, N, 4)).astype(np.float32)
    state = jt.init_state(jax.random.PRNGKey(0), jnp.asarray(pts))
    for i in range(steps):
        pts = rng.uniform(-0.6, 0.6, size=(G, B, N, 4)).astype(np.float32)
        state, _ = jt.step_fn(state, jnp.asarray(pts),
                              jax.random.PRNGKey(10 + i),
                              jnp.asarray(0, jnp.int32))
    return jt, state


def _port(state, dtype, sa_impl="reference"):
    """The port's Trainer and model holding the JAX state's weights."""
    tt = Trainer(_cfg(Config, GroupingConfig, dtype, sa_impl),
                 steps_per_epoch=1, device="cpu")
    st = tt.init_state(0)
    st.model.load_state_dict(from_jax(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, state.batch_stats)))
    return tt, st


def _close(t, j, bar, what):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    np.testing.assert_allclose(t, j, rtol=bar, atol=bar * np.abs(j).max(),
                               err_msg=what)


@pytest.mark.parametrize("dtype,sa_impl", [
    ("float32", "reference"), ("float32", "pair3"),
    ("bfloat16", "reference"), ("bfloat16", "pair3")])
def test_eval_step_matches_jax(rng, dtype, sa_impl):
    """``pair3`` on the port's side resolves to channel-major grouping,
    which the eval step must follow (the JAX package's transposed-
    neighbourhood bug, facl_tpu/train/trainer.py:241-249); its eval is
    the same reference math as JAX's."""
    jt, jstate = _trained_jax(rng, dtype)
    stats = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    # The running statistics moved away from their fresh values.
    assert np.abs(stats["sa_stage"]["mean_0"]).max() > 1e-3
    crops = rng.uniform(-0.6, 0.6, size=(G, B, N, 4)).astype(np.float32)
    jx, jxg = jax_make_eval_step(jt.model, jt.cfg, grouping=jt.g_cfg)(
        jstate.variables, jnp.asarray(crops))
    tt, st = _port(jstate, dtype, sa_impl)
    assert st.model.cfg.channels_first == (sa_impl == "pair3")
    before = {k: v.clone() for k, v in st.model.state_dict().items()}
    x, xg = make_eval_step(st.model, tt.cfg, tt.g_cfg)(
        torch.from_numpy(crops))
    assert x.shape == (B * G, D) and xg.shape == (B, D)
    assert x.dtype == xg.dtype == torch.float32
    _close(x, jx, BARS[dtype], "x")
    _close(xg, jxg, BARS[dtype], "x_global")
    # Eval reads the running statistics and leaves every buffer alone.
    after = st.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_features_from_outputs_is_exact(rng):
    x = rng.normal(size=(B * G, D)).astype(np.float32)
    xg = rng.normal(size=(B, D)).astype(np.float32)
    f = features_from_outputs(x, xg, G)
    np.testing.assert_array_equal(f, np.asarray(jax_fo(x, xg, G)))
    assert f.shape == (B, (G + 1) * D)
    np.testing.assert_array_equal(f[1, :D], x[G])       # video 1, crop 0
    np.testing.assert_array_equal(f[1, G * D:], xg[1])


def _batches(rng, n):
    out = []
    for i in range(n):
        b = B if i < n - 1 else 2                       # a ragged tail
        crops = rng.uniform(-0.6, 0.6, size=(G, b, N, 4)).astype(np.float32)
        out.append((crops, np.arange(b), [f"vid{i}_{j}" for j in range(b)]))
    return out


def test_extract_features_writes_jax_files(rng, tmp_path):
    jt, jstate = _trained_jax(rng, "float32")
    tt, st = _port(jstate, "float32")
    batches = _batches(rng, 3)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jf = jax_extract(jt.model, jstate.variables, jt.cfg,
                     [(jnp.asarray(c), l, n) for c, l, n in batches],
                     out_dir=jdir, grouping=jt.g_cfg)
    tf = extract_features(st.model, tt.cfg,
                          [(torch.from_numpy(c), l, n)
                           for c, l, n in batches],
                          out_dir=tdir, grouping=tt.g_cfg)
    assert sorted(tf) == sorted(jf)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in os.listdir(jdir):
        a, b = np.load(os.path.join(tdir, name)), \
            np.load(os.path.join(jdir, name))
        assert a.shape == b.shape == ((G + 1) * D,) and a.dtype == b.dtype
        _close(a, b, 1e-4, name)
        np.testing.assert_array_equal(a, tf[name[:-4]])


def test_features_from_a_facl_tpu_checkpoint(rng, tmp_path):
    """facl_tpu.train.save_checkpoint -> facl_tpu restore -> from_jax ->
    the port's features equal JAX's from the same restored state."""
    jt, jstate = _trained_jax(rng, "float32", steps=2)
    jax_save_checkpoint(str(tmp_path), jstate, epoch=1)
    fresh = jt.init_state(jax.random.PRNGKey(7),
                          jnp.zeros((G, B, N, 4), jnp.float32))
    restored = jax_restore_latest(str(tmp_path), fresh)
    assert int(restored.step) == 2
    tt, st = _port(restored, "float32")
    batches = _batches(rng, 2)
    jf = jax_extract(jt.model, restored.variables, jt.cfg,
                     [(jnp.asarray(c), l, n) for c, l, n in batches],
                     grouping=jt.g_cfg)
    tf = extract_features(st.model, tt.cfg,
                          [(torch.from_numpy(c), l, n)
                           for c, l, n in batches], grouping=tt.g_cfg)
    assert sorted(tf) == sorted(jf)
    for name in jf:
        _close(tf[name], jf[name], 1e-4, name)


@pytest.mark.parametrize("gather_impl", ["auto", "xla"])
def test_approx_grouping_matches_jax(rng, gather_impl):
    """group_points(method="approx") at (S, N) = (64, 512), K = 64:
    centers equal, and each neighbourhood the same rows as the JAX
    package's (its ``approx_min_k`` on the CPU backend, then the plain
    gather). The order within K may differ: the port's is ascending
    distance, where ``approx_min_k`` returns a few neighbours a float32
    ulp apart out of order; everything downstream reduces over K."""
    pts = rng.uniform(-0.5, 0.5, size=(2, 512, 4)).astype(np.float32)
    d = np.asarray(pairwise_sqdist(jnp.asarray(pts[:, :64, :3]),
                                   jnp.asarray(pts[..., :3])))
    for r2 in (0.06, 0.3):
        jn, jc = jax_group_points(jnp.asarray(pts), 64, 64, r2,
                                  method="approx", gather_impl=gather_impl)
        jn = np.asarray(jn)
        for si in ("auto", "xla"):
            tn, tc = group_points(torch.from_numpy(pts), 64, 64, r2,
                                  method="approx", select_impl=si,
                                  gather_impl=gather_impl)
            tn = tn.numpy()
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
            np.testing.assert_array_equal(_canon(tn), _canon(jn))
            # Rows out of place: pairs a float32 ulp apart.
            for b, s, k in np.argwhere((tn != jn).any(-1)):
                dt, dj = (d[b, s, _point(pts[b], n[b, s, k] +
                                         np.r_[pts[b, s, :3], 0])]
                          for n in (tn, jn))
                assert abs(float(dt) - float(dj)) <= 1e-6, (b, s, k)
            assert (tn != jn).any(-1).mean() < 1e-2


def _canon(n):
    """Each neighbourhood's rows sorted lexicographically."""
    B, S, K, C = n.shape
    flat = n.reshape(B * S, K, C)
    out = np.empty_like(flat)
    for i, rows in enumerate(flat):
        out[i] = rows[np.lexsort(rows.T[::-1])]
    return out.reshape(n.shape)


def _point(cloud, row):
    """Index of the point of ``cloud`` nearest to a gathered ``row``."""
    return int(np.abs(cloud - row).sum(-1).argmin())
