"""SwAV and CLD in the port against the JAX package, on the CPU.

Each piece is held against facl_tpu's: Sinkhorn (with inf entries and
all-zero columns) at rtol 1e-5; the SwAV loss with its queue absent, off
and on, for the loss, its gradient in ``code`` (``jax.grad`` against
autograd) and the shifted queue; k-means (labels equal, centroids at
rtol 1e-5); the CLD pair loss and the windowed CLD loss with their
gradients (G=4: no window, loss 0). A whole SwAV+CLD step of the port's
Trainer against JAX's ``Trainer.step_fn`` at tests/test_train_step.py's
widths, from the same weights (``convert.from_jax``), queue
(``convert.swav_queue_from_jax``) and circle permutation: f32 at
tests/test_sharding.py:173-179's bars (loss terms and queue at rtol 2e-4
/ atol 1e-5) and Adam's first update at 1e-2 lr where the gradient is
well above noise; bf16 at tests/test_torch_bf16_step.py's bars (loss rtol
5e-2, Adam's update sign on 99% of the live entries). Then the queue
gates of tests/test_train_step.py, the shipped
configs/dual_ntu120_large_batch.json stepped at B=4, a checkpoint round
trip with the queue, and two gloo ranks against one process.
"""
import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu import losses as JL
from facl_tpu.config import Config as JaxConfig
from facl_tpu.config import GroupingConfig as JaxGroupingConfig
from facl_tpu.config import LossConfig as JaxLossConfig
from facl_tpu.config import ModelConfig as JaxModelConfig
from facl_tpu.config import OptimConfig as JaxOptimConfig
from facl_tpu.config import TrainConfig as JaxTrainConfig
from facl_tpu.train import Trainer as JaxTrainer
from facl_tpu_torch import losses as TL
from facl_tpu_torch.config import Config, GroupingConfig, LossConfig, \
    ModelConfig, OptimConfig, TrainConfig
from facl_tpu_torch.convert import from_jax, swav_queue_from_jax
from facl_tpu_torch.parallel import spawn
from facl_tpu_torch.train import Trainer, restore_checkpoint, \
    save_checkpoint
from tests.torch_swav_ranks import swav_step_body

ROOT = Path(__file__).resolve().parents[1]
G, B, N = 4, 4, 32
LR = 1e-3


def _t(a):
    return torch.from_numpy(np.asarray(a))


# -- the pieces ---------------------------------------------------------

@pytest.mark.parametrize("case", ["inf", "zero_cols", "both"])
def test_sinkhorn_matches_jax(rng, case):
    Q = np.exp(rng.normal(size=(7, 12)) / 0.5).astype(np.float32)
    if case in ("inf", "both"):
        Q[2, 3] = np.inf
        Q[5, 0] = -np.inf
    if case in ("zero_cols", "both"):
        Q[:, [1, 8]] = 0.0
    want = np.asarray(JL.sinkhorn(jnp.asarray(Q), 3))
    got = TL.sinkhorn(_t(Q), 3).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    # A batch of matrices is each matrix on its own.
    both = TL.sinkhorn(torch.stack([_t(Q), _t(Q[::-1].copy())]), 3)
    np.testing.assert_array_equal(both[0].numpy(), got)


def _swav_inputs(rng, P=6, D=5, Qn=12):
    # Prototype logits of unit embeddings, |code| < 1 as in the model:
    # exp(code / 0.03) stays finite and Sinkhorn's entries normal (JAX's
    # CPU backend flushes subnormals to zero, torch keeps them).
    code = np.tanh(rng.normal(size=(G, B, P))).astype(np.float32)
    xn = rng.normal(size=(G, B, D)).astype(np.float32)
    xn /= np.linalg.norm(xn, axis=-1, keepdims=True)
    w = rng.normal(size=(D, P)).astype(np.float32)
    w /= np.linalg.norm(w, axis=0, keepdims=True)        # unit prototypes
    q = rng.normal(size=(G - 1, Qn, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return code, xn, w, q


@pytest.mark.parametrize("queue", ["none", "off", "on"])
def test_swav_loss_matches_jax(rng, queue):
    code, xn, w, q = _swav_inputs(rng)
    jq = None if queue == "none" else jnp.asarray(q)
    tq = None if queue == "none" else _t(q)
    on = queue == "on"

    def jloss(c):
        return JL.swav_loss(c, jnp.asarray(xn), jnp.asarray(w), jq, on)
    (jl, jnew), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(code))
    tc = _t(code).requires_grad_()
    tl, tnew = TL.swav_loss(tc, _t(xn), _t(w), tq, on)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-6)
    if queue == "none":
        assert tnew is None and jnew is None
    else:
        np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
        np.testing.assert_array_equal(tnew[:, :B].numpy(), xn[:G - 1])


def test_swav_queue_off_equals_no_queue(rng):
    """An off queue scores -inf, exp makes its columns zero, and Sinkhorn
    with zero columns is Sinkhorn without them."""
    code, xn, w, q = _swav_inputs(rng)
    l0, _ = TL.swav_loss(_t(code), _t(xn), _t(w), None, False)
    l1, _ = TL.swav_loss(_t(code), _t(xn), _t(w), _t(q), False)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-5)


@pytest.mark.parametrize("n,k,iters", [(24, 4, 5), (30, 8, 3), (12, 12, 2)])
def test_kmeans_matches_jax(rng, n, k, iters):
    x = rng.normal(size=(n, 6)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    jl, jc = JL.kmeans(jnp.asarray(x), k, iters)
    tl, tc = TL.kmeans(_t(x), k, iters)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-7)


def test_kmeans_empty_cluster_and_too_few_rows():
    x = torch.tensor([[0.0, 0.0], [0.0, 0.0], [1.0, 1.0]])
    labels, c = TL.kmeans(x, 2, 2)        # clusters 0 and 1 seed equal
    jl, jc = JL.kmeans(jnp.asarray(x.numpy()), 2, 2)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    with pytest.raises(ValueError, match="cannot seed"):
        TL.kmeans(x, 4, 1)


@pytest.mark.parametrize("what,g", [("pair", None), ("cld", 6), ("cld", 4)])
def test_cld_matches_jax(rng, what, g):
    D, K = 6, 4
    if what == "pair":
        x = rng.normal(size=(2, 3 * B, D)).astype(np.float32)
    else:
        x = rng.normal(size=(g, B, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)

    def jfn(v):
        if what == "pair":
            return JL.cld_pair_loss(v[0], v[1], num_clusters=K, num_iters=3)
        return JL.cld_loss(v, num_clusters=K, num_iters=3)
    jl, jg = jax.value_and_grad(jfn)(jnp.asarray(x))
    tx = _t(x).requires_grad_()
    tl = TL.cld_pair_loss(tx[0], tx[1], num_clusters=K, num_iters=3) \
        if what == "pair" else TL.cld_loss(tx, num_clusters=K, num_iters=3)
    if g == 4:
        assert float(tl) == 0.0 == float(jl)
        assert not tl.requires_grad or float(torch.autograd.grad(
            tl, tx, allow_unused=True)[0] is None) == 0.0
        return
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    scale = float(np.abs(np.asarray(jg)).max())
    assert scale > 0
    # The gradient runs through the centroid means too: JAX's does.
    np.testing.assert_allclose(tx.grad.numpy() / scale,
                               np.asarray(jg) / scale, atol=1e-5)


# -- the step -----------------------------------------------------------

JAX = (JaxConfig, JaxGroupingConfig, JaxModelConfig, JaxLossConfig,
       JaxTrainConfig, JaxOptimConfig)
PORT = (Config, GroupingConfig, ModelConfig, LossConfig, TrainConfig,
        OptimConfig)


def _cfg(ns, dtype="float32", impl="reference", widths=(8, 16), b=B,
         **loss):
    """tests/test_train_step.py::tiny_config with SwAV and CLD on."""
    cfg_cls, g_cls, m_cls, l_cls, t_cls, o_cls = ns
    loss = dict(dict(use_swav=True, use_cld=True, cld_clusters=4,
                     cld_kmeans_iters=2, swav_queue_start_epoch=0), **loss)
    return cfg_cls(
        grouping=g_cls(num_centroids=8, knn_k=8, radius_sq=10.0),
        model=m_cls(sa_widths=widths, stage2_widths=(16, 32), fc_hidden=32,
                    embed_dim=16, num_prototypes=8, num_crops=G,
                    sa_impl=impl, channels_first=impl in ("pair", "pair3"),
                    compute_dtype=dtype),
        loss=l_cls(**loss),
        train=t_cls(batch_size=b, optim=o_cls(learning_rate=LR)))


def _filled_queue(rng, cfg):
    Qn = cfg.train.batch_size * cfg.loss.swav_queue_factor
    q = rng.normal(size=(G - 1, Qn, cfg.model.embed_dim)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _jax_step(cfg, points, queue, epoch, key):
    jt = JaxTrainer(cfg, steps_per_epoch=10)
    js = jt.init_state(jax.random.PRNGKey(0), jnp.asarray(points))
    sd = from_jax(jax.tree_util.tree_map(np.asarray, js.params),
                  jax.tree_util.tree_map(np.asarray, js.batch_stats))
    if queue is not None:
        js = js.replace(swav_queue=jnp.asarray(queue))
    js2, m = jt.step_fn(js, jnp.asarray(points), key,
                        jnp.asarray(epoch, jnp.int32))
    return sd, js2, {k: float(v) for k, v in m.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swav_cld_step_matches_jax(rng, dtype):
    points = rng.normal(size=(G, B, N, 4)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    perm = torch.tensor(np.asarray(
        jax.random.permutation(jax.random.split(key)[1], G)))
    jcfg = _cfg(JAX, dtype)
    queue = _filled_queue(rng, jcfg)
    sd, js, jm = _jax_step(jcfg, points, queue, 0, key)

    tr = Trainer(_cfg(PORT, dtype), steps_per_epoch=10, device="cpu")
    st = tr.init_state(0)
    assert st.swav_queue.shape == queue.shape
    st.model.load_state_dict(sd)
    st.swav_queue = swav_queue_from_jax(queue)
    before = {n: p.detach().clone() for n, p in st.model.named_parameters()}
    st, tm = tr.step_fn(st, torch.from_numpy(points), perm=perm, epoch=0)
    assert set(tm) == set(jm)
    jq = np.asarray(js.swav_queue)
    if dtype == "float32":
        for k in ("loss", "loss_swav", "loss_cld"):
            np.testing.assert_allclose(float(tm[k]), jm[k], rtol=2e-4,
                                       atol=1e-5, err_msg=k)
        np.testing.assert_allclose(st.swav_queue.numpy(), jq, rtol=2e-4,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(float(tm["loss"]), jm["loss"], rtol=5e-2)
        np.testing.assert_allclose(st.swav_queue.numpy(), jq, atol=5e-2)
    np.testing.assert_array_equal(st.swav_queue[:, B:].numpy(),
                                  queue[:, :-B])
    # Adam's first update is +-lr where the gradient is well above noise.
    jparams = from_jax(jax.tree_util.tree_map(np.asarray, js.params), {})
    checked = agree = 0
    for name, p in st.model.named_parameters():
        if p.grad is None or name.startswith(
                ("sa_stage.bias_", "stage2_mlp.dense_0.bias",
                 "stage2_mlp.dense_1.bias", "head.Dense_0.bias")):
            continue
        g = p.grad.abs()
        mask = g >= (1e-3 if dtype == "float32" else 5e-2) * float(g.max())
        dt = (p.detach() - before[name])[mask]
        dj = (jparams[name] - before[name])[mask]
        checked += int(mask.sum())
        if dtype == "float32":
            np.testing.assert_allclose(dt.numpy(), dj.numpy(),
                                       atol=1e-2 * LR, err_msg=name)
            agree += int(mask.sum())
        else:
            agree += int((torch.sign(dt) == torch.sign(dj)).sum())
    assert "mapping.weight" in dict(st.model.named_parameters())
    assert st.model.mapping.weight.grad is not None   # code feeds SwAV
    assert checked > 0 and agree >= 0.99 * checked, (agree, checked)


def _port(cfg=None, **loss):
    tr = Trainer(cfg or _cfg(PORT, **loss), steps_per_epoch=10,
                 device="cpu")
    return tr, tr.init_state(0)


def test_swav_and_cld_gates(rng):
    """tests/test_train_step.py:51-63: the queue is made, both losses are
    finite, and the queue's front takes the fresh embeddings."""
    tr, st = _port()
    assert st.swav_queue is not None and not st.swav_queue.any()
    pts = torch.from_numpy(rng.normal(size=(G, B, N, 4)).astype(np.float32))
    st, m = tr.step_fn(st, pts, epoch=0)
    assert np.isfinite(float(m["loss_swav"]))
    assert np.isfinite(float(m["loss_cld"]))
    assert st.swav_queue[:, :B].abs().sum() > 0
    assert not st.swav_queue[:, B:].any()


def test_swav_queue_gate_by_epoch_and_last_slot(rng):
    """tests/test_train_step.py:158-172, and the last-slot rule: before
    the start epoch the queue stays untouched; from it the queue shifts by
    B; queue_on is false while the last slot is zero (the loss is then the
    loss without a queue) and true once it is filled."""
    tr, st = _port(swav_queue_start_epoch=5, use_cld=False)
    pts = torch.from_numpy(rng.normal(size=(G, B, N, 4)).astype(np.float32))
    sd = {k: v.clone() for k, v in st.model.state_dict().items()}
    st, m = tr.step_fn(st, pts, perm=torch.arange(G), epoch=0)
    assert not st.swav_queue.any()
    # Same weights, epoch 5: the queue fills at its front...
    st.model.load_state_dict(sd)
    st, m5 = tr.step_fn(st, pts, perm=torch.arange(G), epoch=5)
    assert st.swav_queue[:, :B].abs().sum() > 0
    # ...while its last slot is zero the queue scores nothing.
    tr0, st0 = _port(swav_queue_start_epoch=5, use_cld=False)
    st0.swav_queue = None
    st0.model.load_state_dict(sd)
    _, m0 = tr0.step_fn(st0, pts, perm=torch.arange(G), epoch=5)
    np.testing.assert_allclose(float(m5["loss_swav"]),
                               float(m0["loss_swav"]), rtol=1e-5)
    # A filled last slot turns the queue on: the loss moves.
    q = torch.from_numpy(_filled_queue(rng, tr.cfg))
    st.model.load_state_dict(sd)
    st.swav_queue = q.clone()
    st, m6 = tr.step_fn(st, pts, perm=torch.arange(G), epoch=5)
    assert abs(float(m6["loss_swav"]) - float(m0["loss_swav"])) > 1e-3
    assert torch.equal(st.swav_queue[:, B:], q[:, :-B])
    st.model.load_state_dict(sd)
    st.swav_queue = q.clone()
    st, _ = tr.step_fn(st, pts, perm=torch.arange(G), epoch=4)
    assert torch.equal(st.swav_queue, q)


def test_cld_needs_three_batches_of_rows(rng):
    """k-means seeds from the first K rows of a 3B-row window: K > 3B
    fails, as in JAX, with a clear error."""
    cfg = _cfg(PORT, use_swav=False)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, num_crops=6),
                      loss=dataclasses.replace(cfg.loss,
                                               cld_clusters=3 * B + 1))
    tr, st = _port(cfg)
    pts = torch.from_numpy(rng.normal(size=(6, B, N, 4)).astype(np.float32))
    with pytest.raises(ValueError, match="cannot seed"):
        tr.step_fn(st, pts, epoch=0)


def test_shipped_large_batch_config_steps_on_cpu(rng):
    """configs/dual_ntu120_large_batch.json (bf16, reference, SwAV on) as
    shipped, at B=4: the Trainer builds, the queue is the global batch's,
    and a step at epoch 10 (queue gate open) is finite."""
    cfg = Config.from_json(
        (ROOT / "configs" / "dual_ntu120_large_batch.json").read_text())
    assert cfg.loss.use_swav and cfg.model.compute_dtype == "bfloat16"
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, batch_size=4))
    tr = Trainer(cfg, steps_per_epoch=10, device="cpu")
    st = tr.init_state(0)
    assert st.swav_queue.shape == (9, 4 * 32, 512)
    st.swav_queue[:, -1] = 1.0 / np.sqrt(512)
    pts = torch.from_numpy(rng.normal(size=(10, 4, 512, 4))
                           .astype(np.float32))
    st, m = tr.step_fn(st, pts, epoch=10)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["loss_swav"]))
    assert st.swav_queue[:, :4].abs().sum() > 0


def test_checkpoint_carries_the_queue(rng, tmp_path):
    """Save after a step, restore into a fresh state: the queue comes
    back bit-equal, and the next step equals an uninterrupted run's. A
    file without a queue (written before the queue was saved) restores
    the rest."""
    pts = [torch.from_numpy(rng.normal(size=(G, B, N, 4)).astype(np.float32))
           for _ in range(2)]
    tr, st = _port()
    st, _ = tr.step_fn(st, pts[0], perm=torch.arange(G), epoch=0)
    path = save_checkpoint(str(tmp_path), st, epoch=0)
    st, m = tr.step_fn(st, pts[1], perm=torch.arange(G), epoch=1)

    tr2, fresh = _port()
    fresh = restore_checkpoint(path, fresh)
    assert fresh.swav_queue[:, :B].abs().sum() > 0
    fresh, m2 = tr2.step_fn(fresh, pts[1], perm=torch.arange(G), epoch=1)
    assert float(m2["loss"]) == float(m["loss"])
    assert torch.equal(fresh.swav_queue, st.swav_queue)
    for (n, a), b in zip(st.model.named_parameters(),
                         fresh.model.parameters()):
        assert torch.equal(a, b), n

    old = torch.load(path, weights_only=True)
    del old["swav_queue"]
    torch.save(old, os.path.join(tmp_path, "old.pt"))
    _, target = _port()
    target = restore_checkpoint(os.path.join(tmp_path, "old.pt"), target)
    assert target.step == 1 and not target.swav_queue.any()
    _, off = _port(use_swav=False)
    assert off.swav_queue is None
    p = save_checkpoint(str(tmp_path / "off"), off, epoch=0)
    assert "swav_queue" not in torch.load(p, weights_only=True)
    assert restore_checkpoint(p, off).swav_queue is None


def test_two_ranks_match_one_process(rng):
    """pair3 with SwAV and CLD on two gloo ranks against one process, from
    the same weights, queue and permutation: loss terms at rtol 2e-4, the
    gradients before Adam at normalised max-abs 2e-4
    (tests/test_torch_dp_step.py's bar), the queue bit-equal across the
    ranks, and to one process's at rtol 2e-4 / atol 1e-5."""
    cfg = _cfg(PORT, impl="pair3", widths=(8, 8, 16), b=8)
    points = torch.from_numpy(rng.normal(size=(G, 8, N, 4))
                              .astype(np.float32))
    perm = torch.tensor([2, 0, 3, 1])
    queue = torch.from_numpy(_filled_queue(rng, cfg))
    tr = Trainer(cfg, steps_per_epoch=10, device="cpu")
    st = tr.init_state(0)
    sd = {k: v.clone() for k, v in st.model.state_dict().items()}
    st.swav_queue = queue.clone()
    st, m = tr.step_fn(st, points, perm=perm, epoch=0)
    one = dict(metrics={k: float(v) for k, v in m.items()},
               grads={n: p.grad.clone() for n, p in
                      st.model.named_parameters() if p.grad is not None},
               queue=st.swav_queue)
    r0, r1 = spawn(swav_step_body, 2, "gloo",
                   args=(cfg, sd, queue, points, perm, 0), timeout_s=300)
    assert r0["metrics"] == r1["metrics"]
    for k in ("loss", "loss_swav", "loss_cld"):
        np.testing.assert_allclose(r0["metrics"][k], one["metrics"][k],
                                   rtol=2e-4, err_msg=k)
    assert torch.equal(r0["queue"], r1["queue"])
    np.testing.assert_allclose(r0["queue"].numpy(), one["queue"].numpy(),
                               rtol=2e-4, atol=1e-5)
    assert torch.equal(r0["queue"][:, 8:], queue[:, :-8])
    top = max(float(g.abs().max()) for g in one["grads"].values())
    for n, want in one["grads"].items():
        assert torch.equal(r0["grads"][n], r1["grads"][n]), n
        scale = top if n.startswith(("sa_stage.bias_", "stage2_mlp.dense_0"
                                     ".bias", "stage2_mlp.dense_1.bias",
                                     "head.Dense_0.bias")) else \
            max(float(want.abs().max()), 1e-30)
        err = float((r0["grads"][n] - want).abs().max()) / scale
        assert err <= 2e-4, (n, err)
