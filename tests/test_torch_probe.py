"""The port's linear probe against the JAX package's, on the CPU: the
head's logits from the same weights (``convert.probe_from_jax``), three
epochs of ``LinearProbeTrainer.fit`` from the same initial weights over
the same numpy batch permutations (the StepLR drop inside the run), and
the accuracy and stream-combining helpers.

Tolerances: logits at rtol = atol = 1e-5; parameters after the three
epochs within 1e-4 (absolute; Adam moves each entry by about the learning
rate, 5e-3, a step); topk_accuracy and combine_streams exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu.config import ProbeConfig as JaxProbeConfig
from facl_tpu.eval import LinearProbeTrainer as JaxProbeTrainer
from facl_tpu.eval import combine_streams as jax_combine
from facl_tpu.eval import topk_accuracy as jax_topk
from facl_tpu.models.probe import LinearProbe as JaxLinearProbe
from facl_tpu_torch.config import ProbeConfig
from facl_tpu_torch.convert import probe_from_jax
from facl_tpu_torch.eval import LinearProbeTrainer, combine_streams, \
    topk_accuracy
from facl_tpu_torch.models import LinearProbe

DIM, CLASSES = 40, 7


def test_probe_logits_match_jax(rng):
    x = rng.normal(size=(9, DIM)).astype(np.float32)
    jm = JaxLinearProbe(num_classes=CLASSES)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, DIM)))
    # Reference init: weight ~ N(0, 0.01), bias zero, on both sides.
    tm = LinearProbe(DIM, CLASSES, torch.Generator().manual_seed(0))
    w = tm.Dense_0.weight.detach().numpy()
    assert abs(float(w.std()) - 0.01) < 2e-3
    assert not tm.Dense_0.bias.detach().any()
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["Dense_0"]["bias"] = rng.normal(
        size=CLASSES).astype(np.float32)
    tm.load_state_dict(probe_from_jax(params))
    np.testing.assert_allclose(
        tm(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jm.apply(params, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


def test_fit_three_epochs_matches_jax(rng):
    n = 150
    feats = rng.normal(size=(n, DIM)).astype(np.float32)
    labels = rng.integers(0, CLASSES, size=n).astype(np.int32)
    kw = dict(num_classes=CLASSES, num_epochs=3, lr_decay_epochs=1,
              eval_after_epoch=0)
    jt = JaxProbeTrainer(JaxProbeConfig(**kw), feature_dim=DIM)
    tt = LinearProbeTrainer(ProbeConfig(**kw), feature_dim=DIM,
                            device="cpu")
    tt.model.load_state_dict(probe_from_jax(
        jax.tree_util.tree_map(np.asarray, jt.params)))
    jlog, tlog = [], []
    jbest = jt.fit(feats, labels, feats[:50], labels[:50],
                   log_fn=jlog.append)
    tbest = tt.fit(feats, labels, feats[:50], labels[:50],
                   log_fn=tlog.append)
    assert [tt.lr(e) for e in range(3)] == pytest.approx(
        [5e-3, 5e-3 * 0.7, 5e-3 * 0.49])
    jp = probe_from_jax(jax.tree_util.tree_map(np.asarray, jt.params))
    for name, p in tt.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), jp[name].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)
    # Evaluated after epochs 1 and 2 (> eval_after_epoch) and at the last.
    assert [m["epoch"] for m in tlog] == [m["epoch"] for m in jlog] == [1, 2]
    assert tbest["epoch"] == jbest["epoch"]
    assert tbest["top1"] == pytest.approx(jbest["top1"])
    np.testing.assert_allclose([m["loss"] for m in tlog],
                               [m["loss"] for m in jlog], rtol=1e-4)


def test_topk_and_combine_streams_are_exact(rng):
    logits = rng.normal(size=(30, 12)).astype(np.float32)
    labels = rng.integers(0, 12, size=30)
    for ks in ((1, 5), (1, 2, 12)):
        assert topk_accuracy(logits, labels, ks) == \
            jax_topk(logits, labels, ks)
    assert topk_accuracy(logits, logits.argmax(1), (1,)) == [100.0]
    motion = {f"v{i}": rng.normal(size=4).astype(np.float32)
              for i in range(6)}
    app = {f"v{i}": rng.normal(size=4).astype(np.float32)
           for i in range(2, 8)}
    names = [f"v{i}" for i in range(8)]
    lab = list(range(8))
    tf, tl = combine_streams(motion, app, names, lab)
    jf, jl = jax_combine(motion, app, names, lab)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tl, jl)
    assert tf.shape == (4, 8) and tl.dtype == np.int32


def test_probe_trainer_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        LinearProbeTrainer(ProbeConfig(num_classes=3), feature_dim=4)
