"""MoCo in the port against the JAX package, on the CPU.

The pieces against facl_tpu.models.moco at tests/test_moco.py's bars
(rtol 1e-5, logits 1e-4): the queue's unit rows, the momentum update, the
ring enqueue with its wrap (and JAX's clamped start where the length is no
multiple of the batch), and one ``moco_step``. Then five steps of the
port's MoCoTrainer against five of JAX's from the same weights and the
same queue (``convert.moco_state_from_jax``), on the same views, for
``sa_impl`` reference and pair3 (the port's pair3 twins, JAX's kernels in
interpret mode) at three-layer SA widths: the losses at rtol 2e-3; the
query and key parameters and the running statistics at
tests/test_torch_train_step.py:7-11's bars; the queue after the first
step at rtol 2e-4 / atol 1e-5, after the fifth at rtol 2e-3 / atol 1e-4
(the test says why), and the pointer equal. At bf16 one step at
tests/test_torch_bf16_step.py's bars (loss rtol 5e-2, statistics and the
enqueued keys rtol = atol = 5e-2, Adam's first update's sign on 99% of the
live entries). Then two gloo ranks (tests/torch_moco_ranks.py) against
JAX's unsharded step and the port's one-process step at
tests/test_sharding.py:267-337's bars (loss rtol 2e-4, parameters after
Adam rtol 5e-3 / atol 2 lr, statistics rtol 1e-3 / atol 1e-5, queue rtol
5e-4 / atol 5e-6, pointer equal), the gradients before Adam against one
process at 2e-4 of their scale, the queue bit-equal across the ranks and
the collectives of a step counted. The MoCo CLI on a tiny tree with and
without ``--mesh`` (two ranks: the one-process loss at rtol 2e-4), its
checkpoint restored bit-equal, and the entry points raising without CUDA.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu.config import Config as JaxConfig
from facl_tpu.config import DatagenConfig
from facl_tpu.config import GroupingConfig as JaxGroupingConfig
from facl_tpu.config import ModelConfig as JaxModelConfig
from facl_tpu.config import OptimConfig as JaxOptimConfig
from facl_tpu.config import TrainConfig as JaxTrainConfig
from facl_tpu.data import write_synthetic_dataset
from facl_tpu.models import moco as JM
from facl_tpu.train.moco_trainer import MoCoTrainer as JaxMoCoTrainer
from facl_tpu_torch.config import Config, GroupingConfig, ModelConfig, \
    OptimConfig, TrainConfig
from facl_tpu_torch.convert import from_jax, moco_state_from_jax
from facl_tpu_torch.models import moco as TM
from facl_tpu_torch.parallel import spawn
from facl_tpu_torch.train import MoCoTrainer, MoCoTrainState, \
    latest_checkpoint, restore_checkpoint
from tests.torch_moco_ranks import cli_body, moco_step_body

B, N, Q, STEPS = 4, 32, 16, 5
LR = 1e-3
ABSORBED = ("sa_stage.bias_", "stage2_mlp.dense_0.bias",
            "stage2_mlp.dense_1.bias", "head.Dense_0.bias")


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


# -- the pieces ---------------------------------------------------------

class _Linear(torch.nn.Module):
    """tests/test_moco.py's ``x @ params["w"]``."""

    def __init__(self, w):
        super().__init__()
        self.w = torch.nn.Parameter(torch.tensor(w))


def _encode(mod, x):
    return x @ mod.w


def test_queue_rows_are_unit_and_key_copies_query(rng):
    w = rng.normal(size=(6, 4)).astype(np.float32)
    q, k = _Linear(w), _Linear(np.zeros_like(w))
    st = TM.init_moco_state(q, k, dim=4, queue_len=12,
                            generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(st.queue.norm(dim=1).numpy(), 1.0, rtol=1e-5)
    assert st.queue.shape == (12, 4) and st.queue_ptr == 0
    assert torch.equal(k.w, q.w) and not k.w.requires_grad
    assert not k.training


def test_momentum_update_matches_jax(rng):
    w = rng.normal(size=(6, 4)).astype(np.float32)
    key = {"w": jnp.asarray(w)}
    q2 = {"w": jnp.asarray(w) + 1.0}
    want = np.asarray(JM.momentum_update(q2, key, m=0.9)["w"])
    kt = torch.tensor(w)
    TM.momentum_update([torch.tensor(np.asarray(q2["w"]))], [kt], 0.9)
    np.testing.assert_allclose(kt.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("qlen", [8, 10])
def test_enqueue_ring_matches_jax(rng, qlen):
    """Three enqueues of 4 keys: with 8 rows the pointer wraps to 0 and
    the third write lands at the start; with 10 the third write starts
    where JAX's dynamic_update_slice clamps it (row 6)."""
    js = JM.init_moco_state({"w": jnp.zeros((1,))}, dim=4, queue_len=qlen)
    ts = TM.MoCoState(torch.nn.Identity(),
                      torch.tensor(np.asarray(js.queue)), 0)
    for i in range(3):
        keys = np.arange(16, dtype=np.float32).reshape(4, 4) + 100 * i
        js = JM.enqueue(js, jnp.asarray(keys))
        TM.enqueue(ts, torch.tensor(keys))
        assert ts.queue_ptr == int(js.queue_ptr)
        np.testing.assert_array_equal(ts.queue.numpy(), np.asarray(js.queue))
    assert ts.queue_ptr == 12 % qlen


def test_moco_step_matches_jax(rng):
    w = rng.normal(size=(6, 4)).astype(np.float32)
    js = JM.init_moco_state({"w": jnp.asarray(w)}, dim=4, queue_len=8,
                            rng=jax.random.PRNGKey(1))
    js = js._replace(key_params={"w": jnp.asarray(
        rng.normal(size=(6, 4)).astype(np.float32))})
    xq = rng.normal(size=(4, 6)).astype(np.float32)
    xk = rng.normal(size=(4, 6)).astype(np.float32)
    jl, jlab, js2 = JM.moco_step(lambda p, x: x @ p["w"], {"w": jnp.asarray(
        w)}, js, (jnp.asarray(xq),), (jnp.asarray(xk),), m=0.9,
        temperature=0.5)
    key = _Linear(np.asarray(js.key_params["w"]))
    ts = TM.MoCoState(key, torch.tensor(np.asarray(js.queue)), 0)
    tl, tlab, ts = TM.moco_step(_encode, _Linear(w), ts,
                                (torch.tensor(xq),), (torch.tensor(xk),),
                                m=0.9, temperature=0.5)
    assert tl.shape == (4, 9) and not tlab.any()
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-4)
    np.testing.assert_allclose(key.w.detach().numpy(),
                               np.asarray(js2.key_params["w"]), rtol=1e-5)
    np.testing.assert_allclose(ts.queue.numpy(), np.asarray(js2.queue),
                               rtol=1e-5)
    assert ts.queue_ptr == int(js2.queue_ptr) == 4


# -- the trainer against JAX's -------------------------------------------

def _cfg(ns, impl="reference", dtype="float32", widths=(8, 8, 16)):
    cfg_cls, g_cls, m_cls, t_cls, o_cls = ns
    return cfg_cls(
        grouping=g_cls(num_centroids=8, knn_k=8, radius_sq=10.0),
        model=m_cls(sa_widths=widths, stage2_widths=(16, 32), fc_hidden=32,
                    embed_dim=16, num_prototypes=8, sa_impl=impl,
                    channels_first=impl in ("pair", "pair3"),
                    compute_dtype=dtype),
        train=t_cls(batch_size=B, optim=o_cls(learning_rate=LR)))


JAX = (JaxConfig, JaxGroupingConfig, JaxModelConfig, JaxTrainConfig,
       JaxOptimConfig)
PORT = (Config, GroupingConfig, ModelConfig, TrainConfig, OptimConfig)


def _views(seed, steps, b=B):
    r = np.random.default_rng(seed)
    return r.normal(size=(steps, 2, b, N, 4)).astype(np.float32)


def _jax_run(cfg, views, qlen=Q):
    """JAX's MoCoTrainer over ``views``: (the state before the first
    step as numpy trees, losses, final state)."""
    jt = JaxMoCoTrainer(cfg, steps_per_epoch=10, queue_len=qlen)
    js = jt.init_state(jax.random.PRNGKey(0), jnp.asarray(views[0]))
    start = dict(params=_np(js.params), stats=_np(js.batch_stats),
                 moco=_np(js.moco))
    losses = []
    for v in views:
        js, m = jt.step_fn(js, jnp.asarray(v), jax.random.PRNGKey(1))
        losses.append(float(m["loss"]))
        start.setdefault("queue1", np.array(js.moco.queue))
    return start, losses, js


def _port_state(tr, start, b=B):
    st = tr.init_state(0, b)
    st.model.load_state_dict(from_jax(start["params"], start["stats"]))
    key_sd, queue, ptr = moco_state_from_jax(start["moco"], start["stats"])
    st.moco.key_encoder.load_state_dict(key_sd)
    st.moco.queue, st.moco.queue_ptr = queue, ptr
    return st


def _assert_params(jparams, model_params, grads0, name):
    """tests/test_torch_train_step.py's parameter bar: entries whose
    step-0 gradient is above 1e-3 of its tensor's largest, at atol 3e-3 of
    the parameter scale. BN-absorbed biases are skipped, and so is a
    tensor whose step-0 gradient is round-off (at most 1e-6 of the
    largest gradient: here the last stage-2 shift, which a BatchNorm
    downstream cancels once the single-crop local and global rows agree),
    where Adam moves every entry by +-lr on noise."""
    top = max(float(g.abs().max()) for g in grads0.values())
    total = checked = 0
    for n, jp in from_jax(jparams, {}).items():
        if n.startswith(ABSORBED) or n not in grads0 or \
                float(grads0[n].abs().max()) <= 1e-6 * top:
            continue
        g0 = grads0[n].abs()
        mask = (g0 > 1e-3 * max(float(g0.max()), 1e-12)).numpy()
        tp = model_params[n].detach().numpy()
        scale = max(np.abs(jp.numpy()).max(), np.abs(tp).max(), 1e-8)
        total += mask.size
        checked += int(mask.sum())
        np.testing.assert_allclose(tp[mask] / scale, jp.numpy()[mask] / scale,
                                   atol=3e-3, err_msg=f"{name}: {n}")
    assert checked > 0.5 * total, (checked, total)


def _assert_stats(jstats, buffers, name):
    """Running means at rtol 2e-3 / atol 3e-3 sigma, variances at rtol
    3e-3 (tests/test_torch_train_step.py)."""
    flat = from_jax({}, jstats)
    for n, jv in flat.items():
        tv, jv = buffers[n].numpy(), jv.numpy()
        if n.rsplit(".", 1)[-1].startswith("mean"):
            sigma = float(np.sqrt(flat[n.replace("mean", "var")]
                                  .numpy().mean()))
            np.testing.assert_allclose(tv, jv, rtol=2e-3, atol=3e-3 * sigma,
                                       err_msg=f"{name}: {n}")
        else:
            np.testing.assert_allclose(tv, jv, rtol=3e-3, atol=1e-6,
                                       err_msg=f"{name}: {n}")


@pytest.mark.parametrize("impl", ["reference", "pair3"])
def test_five_steps_match_jax_moco_trainer(impl):
    views = _views(1, STEPS)
    start, jlosses, js = _jax_run(_cfg(JAX, impl), views)
    tr = MoCoTrainer(_cfg(PORT, impl), steps_per_epoch=10, queue_len=Q,
                     device="cpu")
    assert tr.cfg.model.sa_impl == impl and tr.cfg.model.num_crops == 1
    st = _port_state(tr, start)
    tlosses, grads0 = [], {}
    for i, v in enumerate(views):
        st, m = tr.step_fn(st, torch.from_numpy(v))
        tlosses.append(float(m["loss"]))
        if i == 0:
            grads0 = {n: p.grad.clone() for n, p in
                      st.model.named_parameters() if p.grad is not None}
            np.testing.assert_allclose(st.moco.queue.numpy(),
                                       start["queue1"], rtol=2e-4,
                                       atol=1e-5)
    assert st.step == STEPS
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-3)
    _assert_params(_np(js.params), dict(st.model.named_parameters()),
                   grads0, "query")
    _assert_params(_np(js.moco.key_params),
                   dict(st.moco.key_encoder.named_parameters()), grads0,
                   "key")
    _assert_stats(_np(js.batch_stats), dict(st.model.named_buffers()),
                  impl)
    assert st.moco.queue_ptr == int(js.moco.queue_ptr) == (STEPS * B) % Q
    # From the second step on, the key encoder's EMA carries Adam's +-lr
    # moves of the biases whose gradient is round-off (noise, in either
    # framework), and its eval BatchNorm, on running statistics, passes
    # them to the keys: the later keys agree to the loss's bar.
    np.testing.assert_allclose(st.moco.queue.numpy(),
                               np.asarray(js.moco.queue), rtol=2e-3,
                               atol=1e-4)


@pytest.mark.parametrize("impl", ["reference", "pair3"])
def test_bf16_step_matches_jax_moco_trainer(impl):
    views = _views(2, 1)
    start, jlosses, js = _jax_run(_cfg(JAX, impl, "bfloat16"), views)
    tr = MoCoTrainer(_cfg(PORT, impl, "bfloat16"), steps_per_epoch=10,
                     queue_len=Q, device="cpu")
    st = _port_state(tr, start)
    before = {n: p.detach().clone() for n, p in st.model.named_parameters()}
    st, m = tr.step_fn(st, torch.from_numpy(views[0]))
    np.testing.assert_allclose(float(m["loss"]), jlosses[0], rtol=5e-2)
    jparams = from_jax(_np(js.params), {})
    checked = agree = 0
    for n, p in st.model.named_parameters():
        if n.startswith(ABSORBED) or p.grad is None:
            continue
        g = p.grad.abs()
        mask = g >= 0.05 * float(g.max())
        step = p.detach() - before[n]
        assert bool((step.abs() <= LR * 1.001).all()), n
        checked += int(mask.sum())
        agree += int((torch.sign(step)[mask] == torch.sign(
            jparams[n] - before[n])[mask]).sum())
    assert checked > 0 and agree >= 0.99 * checked, (agree, checked)
    buffers = dict(st.model.named_buffers())
    for n, jv in from_jax({}, _np(js.batch_stats)).items():
        np.testing.assert_allclose(buffers[n].numpy(), jv.numpy(),
                                   rtol=5e-2, atol=5e-2, err_msg=n)
    np.testing.assert_allclose(st.moco.queue[:B].numpy(),
                               np.asarray(js.moco.queue)[:B], rtol=5e-2,
                               atol=5e-2)
    assert st.moco.queue_ptr == int(js.moco.queue_ptr) == B


def test_moco_state_from_jax_carries_key_queue_and_pointer():
    start, _, _ = _jax_run(_cfg(JAX), _views(3, 1))
    key_sd, queue, ptr = moco_state_from_jax(start["moco"], start["stats"])
    assert queue.dtype == torch.float32 and ptr == 0
    np.testing.assert_array_equal(queue.numpy(), start["moco"].queue)
    want = from_jax(start["moco"].key_params, start["stats"])
    assert key_sd.keys() == want.keys()
    tr = MoCoTrainer(_cfg(PORT), steps_per_epoch=10, queue_len=Q,
                     device="cpu")
    st = tr.init_state(0, B)
    st.moco.key_encoder.load_state_dict(key_sd)         # strict: every name
    k = start["moco"].key_params["head"]["Dense_1"]["kernel"]
    np.testing.assert_array_equal(
        st.moco.key_encoder.head.Dense_1.weight.numpy(), k.T)


# -- two gloo ranks -------------------------------------------------------

DP_B = 8
DP_CASES = (("pair3", "pair3", (8, 8, 16)), ("reference", "reference",
                                             (8, 16)))


@pytest.fixture(scope="module")
def dp_runs():
    views = _views(4, 3, DP_B)
    out, cases = {}, []
    for label, impl, widths in DP_CASES:
        jcfg, pcfg = _cfg(JAX, impl, widths=widths), _cfg(PORT, impl,
                                                          widths=widths)
        start, jlosses, js = _jax_run(jcfg, views[:1], qlen=2 * DP_B)
        tr = MoCoTrainer(pcfg, steps_per_epoch=10, queue_len=2 * DP_B,
                         device="cpu")
        st = _port_state(tr, start, DP_B)
        sd = {n: t.clone() for n, t in st.model.state_dict().items()}
        key_sd = {n: t.clone() for n, t in
                  st.moco.key_encoder.state_dict().items()}
        queue = st.moco.queue.clone()
        st, m = tr.step_fn(st, torch.from_numpy(views[0]))
        one = dict(loss=float(m["loss"]), queue=st.moco.queue.clone(),
                   grads={n: p.grad.clone() for n, p in
                          st.model.named_parameters() if p.grad is not None})
        out[label] = dict(
            jax=dict(loss=jlosses[0], params=from_jax(_np(js.params), {}),
                     buffers=from_jax({}, _np(js.batch_stats)),
                     queue=np.asarray(js.moco.queue),
                     ptr=int(js.moco.queue_ptr)),
            one=one, widths=widths)
        cases.append((label, pcfg, sd, key_sd, queue, 0))
    ranks = spawn(moco_step_body, 2, "gloo",
                  args=(cases, torch.from_numpy(views), 3), timeout_s=300)
    for label in out:
        out[label]["ranks"] = [r[label] for r in ranks]
    return out


@pytest.mark.parametrize("label", [c[0] for c in DP_CASES])
def test_dp_moco_step_matches_jax_unsharded(dp_runs, label):
    run = dp_runs[label]
    r0, r1 = run["ranks"]
    j = run["jax"]
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], j["loss"], rtol=2e-4)
    for n, w in j["params"].items():
        np.testing.assert_allclose(r0["params"][n].numpy(), w.numpy(),
                                   rtol=5e-3, atol=2 * LR, err_msg=n)
    for n, w in j["buffers"].items():
        np.testing.assert_allclose(r0["buffers"][n].numpy(), w.numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=n)
    # The global key batch entered in global batch order.
    np.testing.assert_allclose(r0["queue"].numpy(), j["queue"], rtol=5e-4,
                               atol=5e-6)
    assert r0["ptr"] == r1["ptr"] == j["ptr"] == DP_B


@pytest.mark.parametrize("label", [c[0] for c in DP_CASES])
def test_dp_moco_matches_one_process_and_ranks_agree(dp_runs, label):
    run = dp_runs[label]
    r0, r1 = run["ranks"]
    one = run["one"]
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=2e-4)
    np.testing.assert_allclose(r0["queue"].numpy(), one["queue"].numpy(),
                               rtol=5e-4, atol=5e-6)
    top = max(float(g.abs().max()) for g in one["grads"].values())
    assert set(r0["grads"]) == set(one["grads"])
    for n, want in one["grads"].items():
        assert torch.equal(r0["grads"][n], r1["grads"][n]), n
        # Round-off gradients (BN-absorbed, or at most 1e-6 of the
        # largest) are held at the bar of the largest gradient.
        scale = top if n.startswith(ABSORBED) or \
            float(want.abs().max()) <= 1e-6 * top else float(want.abs().max())
        err = float((r0["grads"][n] - want).abs().max()) / scale
        assert err <= 2e-4, (n, err)
    assert r0["losses"] == r1["losses"]
    assert torch.equal(r0["queue_end"], r1["queue_end"])
    for n, p in r0["params_end"].items():
        assert torch.equal(p, r1["params_end"][n]), n


@pytest.mark.parametrize("label", [c[0] for c in DP_CASES])
def test_dp_moco_collectives(dp_runs, label):
    """A step's collectives: the B6s sums of pair3 (3 + 3), the BatchNorm
    moment sums forward and backward (stage-2's two layers, the head's
    one layer called twice, the reference SA's layers; the head's second
    call, on the global branch that the MoCo loss does not read, has no
    backward), the query's differentiable gather, the keys' gather and
    one gradient sum; the key encoder (eval) runs none."""
    run = dp_runs[label]
    impl = label
    bn = 2 + 2 + (len(run["widths"]) if impl == "reference" else 0)
    want = {"global_moments": 2 * bn - 1, "gather_negatives": 1,
            "all_gather": 1, "psum_grads": 1}
    if impl == "pair3":
        want["psum"] = 6
    for r in run["ranks"]:
        assert r["counts"] == want


# -- the CLI --------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A tiny tree (tests/test_torch_dp_cli.py's); cli.moco on two gloo
    ranks under --mesh (and its SystemExit on a per-rank batch of 1 with
    pair3), then on one process (this one)."""
    tmp = tmp_path_factory.mktemp("moco_cli")
    root = tmp / "tree"
    dg = DatagenConfig(grid_shape=(24, 24, 24), image_shape=(48, 64),
                       sample_num=256, num_appearance_frames=4,
                       voxel_size=80.0, resolutions=(60, 30, 10))
    write_synthetic_dataset(str(root), num_videos=12, seed=0, datagen_cfg=dg)
    cfg = Config(
        grouping=GroupingConfig(num_centroids=8, knn_k=8, radius_sq=10.0),
        model=ModelConfig(sa_widths=(8, 16), stage2_widths=(16, 32),
                          fc_hidden=32, embed_dim=16, num_prototypes=8))
    cfg_file, pair_file = tmp / "tiny.json", tmp / "pair3.json"
    cfg_file.write_text(cfg.to_json())
    pair_file.write_text(cfg.replace(model=dataclasses.replace(
        cfg.model, sa_impl="pair3")).to_json())
    common = ["--root", str(root), "--dtype", "float32", "--device", "cpu",
              "--epochs", "2"]
    mesh = ["--mesh", "--dist-backend", "gloo"]
    moco = common + ["--batch-size", "4", "--config", str(cfg_file),
                     "--queue-len", "8"]
    odd = common + ["--batch-size", "2", "--config", str(pair_file),
                    "--out", str(tmp / "odd")] + mesh
    ranks = spawn(cli_body, 2, "gloo", timeout_s=300, args=([
        ("moco", moco + mesh + ["--out", str(tmp / "moco_dp")]),
        ("moco", odd)],))
    from facl_tpu_torch.cli import moco as moco_cli
    one = moco_cli.main(moco + ["--out", str(tmp / "moco_1")])
    return dict(tmp=tmp, ranks=ranks, one=one, cfg=cfg)


def test_moco_cli_trains_and_checkpoints(cli_run):
    tmp, one = cli_run["tmp"], cli_run["one"]
    assert len(one) == 2 and all(np.isfinite(h["loss"]) for h in one)
    path = latest_checkpoint(str(tmp / "moco_1"))
    assert path.endswith("ckpt_epoch_00001.pt")
    saved = torch.load(path, weights_only=True)
    tr = MoCoTrainer(cli_run["cfg"], steps_per_epoch=1, queue_len=8,
                     device="cpu")
    st = restore_checkpoint(path, tr.init_state(0, 4))
    assert isinstance(st, MoCoTrainState) and st.step == saved["step"] > 0
    for n, t in st.model.state_dict().items():
        assert torch.equal(t, saved["model"][n]), n
    for n, t in st.moco.key_encoder.state_dict().items():
        assert torch.equal(t, saved["moco"]["key_encoder"][n]), n
    assert torch.equal(st.moco.queue, saved["moco"]["queue"])
    assert st.moco.queue_ptr == saved["moco"]["queue_ptr"] == \
        (saved["step"] * 4) % 8
    # A MoCo checkpoint does not restore into a plain TrainState.
    from facl_tpu_torch.train import Trainer
    with pytest.raises(ValueError, match="MoCo"):
        restore_checkpoint(path, Trainer(cli_run["cfg"], 1, device="cpu")
                           .init_state(0))


def test_moco_cli_under_mesh_matches_one_process(cli_run):
    ranks, one = cli_run["ranks"], cli_run["one"]
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        hist, odd = r["results"]
        assert [h["loss"] for h in hist] == \
            [h["loss"] for h in ranks[0]["results"][0]]
        assert r["counts"]["all_gather"] > 0
        assert "per-rank batch 2//2=1 must be even" in odd
    np.testing.assert_allclose(ranks[0]["results"][0][0]["loss"],
                               one[0]["loss"], rtol=2e-4)
    assert os.path.exists(cli_run["tmp"] / "moco_dp" / "index.json")


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the entry points run on the CUDA device here")
    from facl_tpu_torch.cli import moco as moco_cli
    with pytest.raises(RuntimeError, match="CUDA"):
        MoCoTrainer(_cfg(PORT), steps_per_epoch=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        moco_cli.main(["--root", "unused"])
