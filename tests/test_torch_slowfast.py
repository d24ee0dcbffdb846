"""The slow/fast encoder and its trainer in the port against the JAX
package, on the CPU.

``PointNetSlowFast``'s forward from JAX's variables (``convert.from_jax``,
the submodule names unchanged) in train mode (the outputs and the updated
running statistics) and in eval mode, at rtol 1e-5 / atol 1e-5 of the
tensor's scale. Six steps of the
port's SlowFastTrainer against six of JAX's from the same weights on the
same six batches of clouds at tests/test_torch_train_step.py:7-11's
bars; six on the same clouds six times (tests/test_model.py:162-185's
recipe: the loss falls) with the losses at rtol 2e-3; one bf16 step at
tests/test_torch_bf16_step.py's. The pair InfoNCE's cross-entropy under a
permutation of the rows. Two gloo ranks (tests/torch_moco_ranks.py) each
on its block of every crop batch, flattened as the pretrain CLI does,
against JAX's unsharded step at tests/test_sharding.py:267-337's bars
(loss rtol 2e-4, parameters after Adam rtol 5e-3 / atol 2 lr) and the
running statistics at rtol 1e-3 / atol 1e-5; the gradients before Adam
against the port's one process at 2e-4 of their scale, the ranks
bit-equal after three steps and the collectives of a step counted. Then
``pretrain`` with a slow_fast config on a tiny tree, with and without
``--mesh`` (the one-process loss at rtol 2e-4), its checkpoint restored
bit-equal; slow_fast's ValueError where a single-encoder path is asked
for, and the trainer raising without CUDA."""
import dataclasses

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
from facl_tpu.models import PointNetSlowFast as JaxPointNetSlowFast
from facl_tpu.ops.grouping import group_points as jax_group_points
from facl_tpu.train.slowfast_trainer import SlowFastTrainer as \
    JaxSlowFastTrainer
from facl_tpu_torch.config import Config, GroupingConfig, ModelConfig, \
    OptimConfig, TrainConfig
from facl_tpu_torch.convert import from_jax
from facl_tpu_torch.losses import cross_entropy, pair_infonce
from facl_tpu_torch.models import PointNetSlowFast
from facl_tpu_torch.models.pointnet import resolve_grouping, resolve_model
from facl_tpu_torch.parallel import spawn
from facl_tpu_torch.train import SlowFastTrainer, SlowFastTrainState, \
    latest_checkpoint, restore_checkpoint
from tests.torch_moco_ranks import cli_body, slowfast_step_body

N, SLOW_K, FAST_K = 32, 16, 8
LR = 1e-3
#: Linear biases followed by a BatchNorm: their exact gradient is zero.
ABSORBED = tuple(f"{b}.dense_{i}.bias" for b in ("slow1", "fast1", "slow3",
                                                 "fast3")
                 for i in range(3)) + ("head_slow.Dense_0.bias",
                                       "head_fast.Dense_0.bias")


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _cfg(ns, dtype="float32", batch=4):
    """tests/test_model.py::small_cfg's slow/fast widths."""
    cfg_cls, g_cls, m_cls, t_cls, o_cls = ns
    return cfg_cls(
        grouping=g_cls(num_centroids=8, knn_k=8, radius_sq=10.0),
        model=m_cls(name="slow_fast", fc_hidden=32, embed_dim=24,
                    slow_widths1=(4, 8, 16), slow_widths3=(16, 32, 32),
                    fast_widths1=(8, 16, 32), fast_widths3=(32, 32, 64),
                    compute_dtype=dtype),
        train=t_cls(batch_size=batch, optim=o_cls(learning_rate=LR)))


JAX = (JaxConfig, JaxGroupingConfig, JaxModelConfig, JaxTrainConfig,
       JaxOptimConfig)
PORT = (Config, GroupingConfig, ModelConfig, TrainConfig, OptimConfig)


# -- the module -----------------------------------------------------------

def test_forward_matches_jax_train_and_eval(rng):
    pts = jnp.asarray(rng.normal(size=(4, N, 4)).astype(np.float32))
    slow, _ = jax_group_points(pts, 8, SLOW_K, radius_sq=10.0)
    fast, _ = jax_group_points(pts, 8, FAST_K, radius_sq=10.0)
    cfg = _cfg(JAX).model
    jm = JaxPointNetSlowFast(cfg)
    variables = jm.init(jax.random.PRNGKey(0), slow, fast, train=False)
    params, stats = _np(variables["params"]), _np(variables["batch_stats"])
    (jf, js_), mutated = jm.apply(variables, slow, fast, train=True,
                                  mutable=["batch_stats"])
    ef, es = jm.apply(variables, slow, fast, train=False)

    tm = PointNetSlowFast(_cfg(PORT).model)
    tm.load_state_dict(from_jax(params, stats))          # strict: every name
    ts, tf = (torch.from_numpy(np.array(t)) for t in (slow, fast))
    tm.train()
    xf, xs = tm(ts, tf)
    for got, want in ((xf, jf), (xs, js_)):
        assert got.dtype == torch.float32 and got.shape == (4, 24)
        _close(got.detach(), want)
    buffers = dict(tm.named_buffers())
    for n, w in from_jax({}, _np(mutated["batch_stats"])).items():
        _close(buffers[n], w, n)
    tm.load_state_dict(from_jax(params, stats))
    tm.eval()
    with torch.no_grad():
        xf, xs = tm(ts, tf)
    _close(xf, ef)
    _close(xs, es)


def _close(got, want, name=""):
    """rtol 1e-5 / atol 1e-5 of the tensor's scale: the head's BatchNorm
    normalises 4 rows, so an entry near zero carries the round-off of the
    row's scale."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=name)


def test_slow_fast_is_a_value_error_for_the_single_encoder_path():
    cfg = _cfg(PORT)
    for fn in (resolve_grouping, resolve_model):
        with pytest.raises(ValueError, match="SlowFastTrainer"):
            fn(cfg)


def test_pair_infonce_is_invariant_under_a_row_permutation(rng):
    """The data-parallel step computes the loss on the rows in rank order,
    a permutation of the one-process order: the mean cross-entropy is the
    same (up to the order of its sums)."""
    x0, x1 = (torch.from_numpy(rng.normal(size=(12, 6)).astype(np.float32))
              for _ in range(2))
    perm = torch.from_numpy(rng.permutation(12))

    def loss(a, b):
        return float(cross_entropy(*pair_infonce(a, b, torch.cat([a, b]))))
    np.testing.assert_allclose(loss(x0[perm], x1[perm]), loss(x0, x1),
                               rtol=1e-6)


# -- the trainer against JAX's -------------------------------------------

def _jax_run(cfg, clouds):
    """JAX's SlowFastTrainer over ``clouds`` (steps, B, N, C)."""
    jt = JaxSlowFastTrainer(cfg, steps_per_epoch=10, slow_k=SLOW_K,
                            fast_k=FAST_K)
    js = jt.init_state(jax.random.PRNGKey(0), jnp.asarray(clouds[0]))
    start = dict(params=_np(js.params), stats=_np(js.batch_stats))
    losses = []
    for i, c in enumerate(clouds):
        js, m = jt.step_fn(js, jnp.asarray(c), jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    return start, losses, js


def _port(cfg, start, mesh=None):
    tr = SlowFastTrainer(cfg, steps_per_epoch=10, slow_k=SLOW_K,
                         fast_k=FAST_K, device="cpu", mesh=mesh)
    st = tr.init_state(0)
    st.model.load_state_dict(from_jax(start["params"], start["stats"]))
    return tr, st


def test_six_steps_match_jax_slowfast_trainer(rng):
    """Six steps on six batches of clouds, at
    tests/test_torch_train_step.py's bars."""
    clouds = [rng.normal(size=(4, N, 4)).astype(np.float32)
              for _ in range(6)]
    start, jlosses, js = _jax_run(_cfg(JAX), clouds)
    tr, st = _port(_cfg(PORT), start)
    tlosses, grads0 = [], {}
    for i, c in enumerate(clouds):
        st, m = tr.step_fn(st, torch.from_numpy(c))
        tlosses.append(float(m["loss"]))
        if i == 0:
            grads0 = {n: p.grad.clone() for n, p in
                      st.model.named_parameters()}
    assert st.step == 6
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-3)
    top = max(float(g.abs().max()) for g in grads0.values())
    live = dict(st.model.named_parameters())
    total = checked = 0
    for n, jp in from_jax(_np(js.params), {}).items():
        if n in ABSORBED or float(grads0[n].abs().max()) <= 1e-6 * top:
            continue
        g0 = grads0[n].abs()
        mask = (g0 > 1e-3 * float(g0.max())).numpy()
        tp = live[n].detach().numpy()
        scale = max(np.abs(jp.numpy()).max(), np.abs(tp).max(), 1e-8)
        total += mask.size
        checked += int(mask.sum())
        np.testing.assert_allclose(tp[mask] / scale, jp.numpy()[mask] / scale,
                                   atol=3e-3, err_msg=n)
    assert checked > 0.5 * total, (checked, total)
    stats = from_jax({}, _np(js.batch_stats))
    buffers = dict(st.model.named_buffers())
    for n, jv in stats.items():
        if n.endswith(".mean"):
            sigma = float(np.sqrt(stats[n[:-4] + "var"].numpy().mean()))
            np.testing.assert_allclose(buffers[n].numpy(), jv.numpy(),
                                       rtol=2e-3, atol=3e-3 * sigma,
                                       err_msg=n)
        else:
            np.testing.assert_allclose(buffers[n].numpy(), jv.numpy(),
                                       rtol=3e-3, atol=1e-6, err_msg=n)


def test_loss_falls_on_fixed_clouds_as_jax_does(rng):
    """tests/test_model.py:162-185 on both sides: the same clouds six
    times, the two pathways align and the loss falls; the losses at rtol
    2e-3. (The parameters are held on fresh batches above: here the loss
    falls 40-fold, its gradients shrink with it, and Adam, which moves an
    entry by lr whatever its gradient's size, turns their round-off into
    parameter differences of a share of lr.)"""
    pts = rng.normal(size=(4, N, 4)).astype(np.float32)
    _, jlosses, _ = _jax_run(_cfg(JAX), [pts] * 6)
    tr, st = _port(_cfg(PORT), _jax_run(_cfg(JAX), [pts])[0])
    tlosses = []
    for _ in range(6):
        st, m = tr.step_fn(st, torch.from_numpy(pts))
        tlosses.append(float(m["loss"]))
    assert np.isfinite(tlosses).all() and tlosses[-1] < tlosses[0]
    assert jlosses[-1] < jlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=2e-3)


def test_bf16_step_matches_jax_slowfast_trainer(rng):
    """tests/test_torch_bf16_step.py's bars: loss rtol 5e-2, running
    statistics rtol = atol = 5e-2, Adam's first update's sign on 99% of
    the entries whose gradient is at least 5% of its tensor's largest."""
    pts = rng.normal(size=(4, N, 4)).astype(np.float32)
    start, jlosses, js = _jax_run(_cfg(JAX, "bfloat16"), [pts])
    tr, st = _port(_cfg(PORT, "bfloat16"), start)
    assert st.model.dtype == torch.bfloat16
    before = {n: p.detach().clone() for n, p in st.model.named_parameters()}
    st, m = tr.step_fn(st, torch.from_numpy(pts))
    np.testing.assert_allclose(float(m["loss"]), jlosses[0], rtol=5e-2)
    jparams = from_jax(_np(js.params), {})
    checked = agree = 0
    for n, p in st.model.named_parameters():
        assert p.dtype == torch.float32, n
        if n in ABSORBED:
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


# -- two gloo ranks -------------------------------------------------------

DP_G, DP_B = 2, 4


@pytest.fixture(scope="module")
def dp_run():
    """Crop batches (steps, G, B, N, C): JAX's unsharded step and the
    port's one process on the first batch flattened crop-major (G*B
    clouds, as the pretrain CLI does), the two ranks on their blocks."""
    r = np.random.default_rng(5)
    points = r.normal(size=(3, DP_G, DP_B, N, 4)).astype(np.float32)
    flat = points[0].reshape(DP_G * DP_B, N, 4)
    start, jlosses, js = _jax_run(_cfg(JAX, batch=DP_B), [flat])
    cfg = _cfg(PORT, batch=DP_B)
    tr, st = _port(cfg, start)
    sd = {n: t.clone() for n, t in st.model.state_dict().items()}
    st, m = tr.step_fn(st, torch.from_numpy(flat))
    one = dict(loss=float(m["loss"]),
               grads={n: p.grad.clone() for n, p in
                      st.model.named_parameters()})
    (r0, r1) = (r["f32"] for r in spawn(
        slowfast_step_body, 2, "gloo",
        args=([("f32", cfg, sd)], torch.from_numpy(points), 3),
        timeout_s=300))
    return dict(jax=dict(loss=jlosses[0],
                         params=from_jax(_np(js.params), {}),
                         buffers=from_jax({}, _np(js.batch_stats))),
                one=one, ranks=(r0, r1))


def test_dp_slowfast_step_matches_jax_unsharded(dp_run):
    r0, r1 = dp_run["ranks"]
    j = dp_run["jax"]
    assert r0["loss"] == r1["loss"]
    np.testing.assert_allclose(r0["loss"], j["loss"], rtol=2e-4)
    for n, w in j["params"].items():
        np.testing.assert_allclose(r0["params"][n].numpy(), w.numpy(),
                                   rtol=5e-3, atol=2 * LR, err_msg=n)
    for n, w in j["buffers"].items():
        np.testing.assert_allclose(r0["buffers"][n].numpy(), w.numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=n)


def test_dp_slowfast_matches_one_process_and_ranks_agree(dp_run):
    r0, r1 = dp_run["ranks"]
    one = dp_run["one"]
    np.testing.assert_allclose(r0["loss"], one["loss"], rtol=2e-4)
    top = max(float(g.abs().max()) for g in one["grads"].values())
    for n, want in one["grads"].items():
        assert torch.equal(r0["grads"][n], r1["grads"][n]), n
        scale = top if n in ABSORBED or \
            float(want.abs().max()) <= 1e-6 * top else float(want.abs().max())
        err = float((r0["grads"][n] - want).abs().max()) / scale
        assert err <= 2e-4, (n, err)
    assert r0["losses"] == r1["losses"]
    for n, p in r0["params_end"].items():
        assert torch.equal(p, r1["params_end"][n]), n


def test_dp_slowfast_collectives(dp_run):
    """A step's collectives: the BatchNorm moment sums of the fourteen
    BatchNorms (three a shared MLP, one a head) forward and backward, the
    gathers of the two embeddings and one gradient sum."""
    for r in dp_run["ranks"]:
        assert r["counts"] == {"global_moments": 28, "gather_negatives": 2,
                               "psum_grads": 1}


# -- the pretrain CLI -------------------------------------------------------

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """pretrain with a slow_fast config on tests/test_torch_dp_cli.py's
    tiny tree: two gloo ranks under --mesh, then one process (this one)."""
    tmp = tmp_path_factory.mktemp("slowfast_cli")
    root = tmp / "tree"
    dg = DatagenConfig(grid_shape=(24, 24, 24), image_shape=(48, 64),
                       sample_num=256, num_appearance_frames=4,
                       voxel_size=80.0, resolutions=(60, 30, 10))
    write_synthetic_dataset(str(root), num_videos=12, seed=0, datagen_cfg=dg)
    cfg = _cfg(PORT)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, slow_widths1=(4, 8), slow_widths3=(8, 16),
        fast_widths1=(8, 8), fast_widths3=(8, 16)))
    cfg_file = tmp / "slowfast.json"
    cfg_file.write_text(cfg.to_json())
    common = ["--root", str(root), "--config", str(cfg_file), "--dtype",
              "float32", "--device", "cpu", "--batch-size", "4",
              "--epochs", "2"]
    ranks = spawn(cli_body, 2, "gloo", timeout_s=300, args=([
        ("pretrain", common + ["--mesh", "--dist-backend", "gloo", "--out",
                               str(tmp / "ck_dp")])],))
    from facl_tpu_torch.cli import pretrain
    one = pretrain.main(common + ["--out", str(tmp / "ck_1")])
    return dict(tmp=tmp, ranks=ranks, one=one, cfg=cfg, common=common)


def test_pretrain_slow_fast_trains_and_checkpoints(cli_run):
    tmp, one = cli_run["tmp"], cli_run["one"]
    assert len(one) == 2 and all(np.isfinite(h["loss"]) for h in one)
    path = latest_checkpoint(str(tmp / "ck_1"))
    assert path.endswith("ckpt_epoch_00001.pt")
    saved = torch.load(path, weights_only=True)
    tr = SlowFastTrainer(cli_run["cfg"], 1, device="cpu")
    st = restore_checkpoint(path, tr.init_state(0))
    assert isinstance(st, SlowFastTrainState)
    assert st.step == saved["step"] > 0
    for n, t in st.model.state_dict().items():
        assert torch.equal(t, saved["model"][n]), n
    # The single-encoder extraction path refuses it, as JAX's does.
    from facl_tpu_torch.cli import extract
    with pytest.raises(ValueError, match="SlowFastTrainer"):
        extract.main(cli_run["common"][:8] + [
            "--checkpoint", str(tmp / "ck_1"), "--out", str(tmp / "feat")])


def test_pretrain_slow_fast_under_mesh_matches_one_process(cli_run):
    ranks, one = cli_run["ranks"], cli_run["one"]
    for r in ranks:
        (hist,) = r["results"]
        assert [h["loss"] for h in hist] == \
            [h["loss"] for h in ranks[0]["results"][0]]
        assert r["counts"]["gather_negatives"] > 0
    np.testing.assert_allclose(ranks[0]["results"][0][0]["loss"],
                               one[0]["loss"], rtol=2e-4)
    assert (cli_run["tmp"] / "ck_dp" / "index.json").exists()


def test_trainer_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("the trainer runs on the CUDA device here")
    with pytest.raises(RuntimeError, match="CUDA"):
        SlowFastTrainer(_cfg(PORT), steps_per_epoch=1)
