"""The port's tensor parallelism (``mesh.mp > 1``) on gloo ranks on the CPU
(the kernels' twins): the train step at dp = 1 x mp = 2 and dp = 2 x
mp = 2 against the JAX package's UNSHARDED step from the same weights
(``convert.from_jax``), on the same points and circle permutation, and
against the port's own one-process step; MoCo and slow/fast at mp = 2
against the port's one process; the split set against JAX's
``param_sharding``; checkpoints written on mp = 2.

The model is tests/test_sharding.py's ``tiny_config`` with Denses of 512
output columns, so that the mp rule has something to split (as
``test_shard_train_state_places_opt_state`` widens ``fc_hidden``): SA
(8, 8, 16), stage-2 (16, 32, 512), ``fc_hidden`` 512, ``embed_dim`` 512.
Split: stage-2's 32->512, the head's 512->512 twice.

Bars. f32 against JAX, those of tests/test_sharding.py:34-71 (as
tests/test_torch_dp_step.py): the loss at rtol 2e-4, the parameters after
the first Adam step at rtol 5e-3 / atol 2 lr, the BatchNorm running
statistics at rtol 1e-3 / atol 1e-5; bf16 against JAX at the JAX
package's bf16 bars (loss rtol 5e-2, statistics rtol = atol = 5e-2). The
gradients before Adam against the port's one process at max-abs 2e-4 of
each tensor's scale in f32 (a missing mp sum of the split GEMMs' input
cotangent halves the gradients below them, a sum over every rank instead
of the dp group doubles them; Adam's scale-invariant first step would
hide either). bf16 against one process computing each split Dense as two
column-block GEMMs (tests/torch_two_halves.py::as_column_blocks; at
dp = 2 also by halves, ``as_two_halves``): at mp = 2 the loss, the
running statistics and every gradient bit-equal; at dp = 2 x mp = 2 the
loss and the running statistics.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from facl_tpu.config import Config as JaxConfig
from facl_tpu.config import GroupingConfig as JaxGroupingConfig
from facl_tpu.config import MeshConfig as JaxMeshConfig
from facl_tpu.config import ModelConfig as JaxModelConfig
from facl_tpu.config import OptimConfig as JaxOptimConfig
from facl_tpu.config import TrainConfig as JaxTrainConfig
from facl_tpu.parallel import make_mesh as jax_make_mesh
from facl_tpu.parallel import param_sharding
from facl_tpu.train import Trainer as JaxTrainer
from facl_tpu_torch.config import Config, GroupingConfig, ModelConfig, \
    OptimConfig, TrainConfig
from facl_tpu_torch.convert import from_jax
from facl_tpu_torch.parallel import spawn
from facl_tpu_torch.train import MoCoTrainer, SlowFastTrainer, Trainer, \
    restore_checkpoint, save_checkpoint
from tests.torch_dp_ranks import mp_collectives_body, \
    mp_moco_slowfast_body, mp_step_body
from tests.torch_two_halves import as_column_blocks, as_two_halves

G, B, N, C = 4, 8, 32, 4
LR = 1e-3
STEPS = 2
WIDE = 512
#: (label, sa_impl, compute dtype).
CASES = (("pair3", "pair3", "float32"),
         ("reference", "reference", "float32"),
         ("pair3 bf16", "pair3", "bfloat16"),
         ("reference bf16", "reference", "bfloat16"))
#: (label, (dp, mp), the CASES run there).
MESHES = (("mp2", (1, 2), [c[0] for c in CASES]),
          ("dp2xmp2", (2, 2), ["pair3", "pair3 bf16"]))
RUNS = [(m, c) for m, _, cases in MESHES for c in cases]
SPLIT = {"stage2_mlp.dense_2.weight", "head.Dense_0.weight",
         "head.Dense_1.weight"}
ABSORBED = ("sa_stage.bias_", "stage2_mlp.dense_0.bias",
            "stage2_mlp.dense_1.bias", "stage2_mlp.dense_2.bias",
            "head.Dense_0.bias")


def _cfg(ns, impl, dtype):
    cfg_cls, g_cls, m_cls, t_cls, o_cls = ns
    return cfg_cls(
        grouping=g_cls(num_centroids=8, knn_k=8, radius_sq=10.0),
        model=m_cls(sa_widths=(8, 8, 16), stage2_widths=(16, 32, WIDE),
                    fc_hidden=WIDE, embed_dim=WIDE, num_prototypes=8,
                    num_crops=G, sa_impl=impl,
                    channels_first=impl in ("pair", "pair3"),
                    compute_dtype=dtype),
        train=t_cls(batch_size=B, optim=o_cls(learning_rate=LR)))


JAX = (JaxConfig, JaxGroupingConfig, JaxModelConfig, JaxTrainConfig,
       JaxOptimConfig)
PORT = (Config, GroupingConfig, ModelConfig, TrainConfig, OptimConfig)


def _one_process(cfg, sd, points, perm, witness=()):
    """The port's one-process step, inside the ``witness`` contexts."""
    tr = Trainer(cfg, steps_per_epoch=10, device="cpu")
    st = tr.init_state(0)
    st.model.load_state_dict(sd)
    with contextlib.ExitStack() as stack:
        for w in witness:
            stack.enter_context(w())
        st, m = tr.step_fn(st, points, perm=perm)
    return dict(loss=float(m["loss"]),
                grads={n: p.grad.clone() for n, p in
                       st.model.named_parameters() if p.grad is not None},
                buffers={n: b.clone() for n, b in st.model.named_buffers()},
                state=st)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    points = rng.normal(size=(G, B, N, C)).astype(np.float32)
    key, ep = jax.random.PRNGKey(1), jnp.asarray(0)
    perm = torch.tensor(np.asarray(
        jax.random.permutation(jax.random.split(key)[1], G)))
    pts = torch.from_numpy(points)
    out, cases = {}, {}
    for label, impl, dtype in CASES:
        jt = JaxTrainer(_cfg(JAX, impl, dtype), steps_per_epoch=10)
        js = jt.init_state(jax.random.PRNGKey(0), jnp.asarray(points))
        params = jax.tree_util.tree_map(np.asarray, js.params)
        sd = from_jax(params, jax.tree_util.tree_map(np.asarray,
                                                     js.batch_stats))
        js, jm = jt.step_fn(js, jnp.asarray(points), key, ep)
        cfg = _cfg(PORT, impl, dtype)
        out[label] = dict(
            jax=dict(loss=float(jm["loss"]),
                     params=from_jax(jax.tree_util.tree_map(
                         np.asarray, js.params), {}),
                     buffers=from_jax({}, jax.tree_util.tree_map(
                         np.asarray, js.batch_stats))),
            one=_one_process(cfg, sd, pts, perm))
        if dtype == "bfloat16":
            out[label]["columns"] = _one_process(cfg, sd, pts, perm,
                                                 (as_column_blocks,))
            out[label]["columns halves"] = _one_process(
                cfg, sd, pts, perm, (as_column_blocks, as_two_halves))
        cases[label] = (label, cfg, sd)
        out[label]["sd"] = sd
    out["jax_params"] = params
    ckpt = str(tmp_path_factory.mktemp("mp_ckpt"))
    out["ckpt"] = ckpt
    for mesh, shape, labels in MESHES:
        ranks = spawn(mp_step_body, shape[0] * shape[1], "gloo",
                      args=(shape, [cases[k] for k in labels], pts, perm,
                            STEPS, ckpt if mesh == "mp2" else None),
                      timeout_s=300)
        out[mesh] = ranks
        for label in labels:
            out[label][mesh] = [r[label] for r in ranks]
    return out


def _max_rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-30)


@pytest.mark.parametrize("mesh,label", RUNS)
def test_mp_step_matches_jax_unsharded(runs, mesh, label):
    run = runs[label]
    ranks = run[mesh]
    assert len({r["loss"] for r in ranks}) == 1   # the global loss on each
    r0 = ranks[0]
    if "bf16" in label:
        np.testing.assert_allclose(r0["loss"], run["jax"]["loss"],
                                   rtol=5e-2)
        for n, w in run["jax"]["buffers"].items():
            np.testing.assert_allclose(r0["buffers"][n].numpy(), w.numpy(),
                                       rtol=5e-2, atol=5e-2, err_msg=n)
        return
    np.testing.assert_allclose(r0["loss"], run["jax"]["loss"], rtol=2e-4)
    for n, w in run["jax"]["params"].items():
        np.testing.assert_allclose(r0["params"][n].numpy(), w.numpy(),
                                   rtol=5e-3, atol=2 * LR, err_msg=n)
    for n, w in run["jax"]["buffers"].items():
        np.testing.assert_allclose(r0["buffers"][n].numpy(), w.numpy(),
                                   rtol=1e-3, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("mesh,label", [r for r in RUNS
                                        if "bf16" not in r[1]])
def test_mp_gradients_match_one_process(runs, mesh, label):
    """The gradients before Adam (a split weight's blocks joined) against
    the one-process step's, at max-abs 2e-4 of each tensor's scale; the
    BN-absorbed biases, whose exact gradient is zero, at 2e-4 of the
    largest gradient. Equal on every rank."""
    run = runs[label]
    one = run["one"]["grads"]
    top = max(float(g.abs().max()) for g in one.values())
    for r in run[mesh]:
        assert set(r["grads"]) == set(one)
        for n, want in one.items():
            got = r["grads"][n]
            assert torch.equal(got, run[mesh][0]["grads"][n]), n
            err = float((got - want).abs().max()) / top \
                if n.startswith(ABSORBED) else _max_rel(got, want)
            assert err <= 2e-4, (n, err)


@pytest.mark.parametrize("mesh,label", [r for r in RUNS if "bf16" in r[1]])
def test_mp_bf16_matches_column_block_witness(runs, mesh, label):
    """bf16 at mp = 2 against one process computing each split Dense as
    two column-block GEMMs: the loss, the running statistics and every
    gradient before Adam bit-equal (the ranks of an mp block run the
    same rows; the blocks' input cotangents are summed as autograd sums
    the witness's). At dp = 2 x mp = 2 against the witness also split by
    halves of the batch: the loss and the running statistics (the
    gradients' sums over rows round otherwise; test_torch_dp_step.py
    says why)."""
    run = runs[label]
    want = run["columns" if mesh == "mp2" else "columns halves"]
    for r in run[mesh]:
        assert r["loss"] == want["loss"]
        for n, w in want["buffers"].items():
            assert torch.equal(r["buffers"][n], w), n
        if mesh == "mp2":
            for n, w in want["grads"].items():
                assert torch.equal(r["grads"][n], w), n


@pytest.mark.parametrize("mesh,label", RUNS)
def test_mp_ranks_stay_bit_equal(runs, mesh, label):
    """After two steps every rank holds the same whole parameters, and
    each split weight's blocks are the ranks' own: different on the two
    ranks of an mp block, equal across dp blocks."""
    ranks = runs[label][mesh]
    for r in ranks:
        for n, p in ranks[0]["params_end"].items():
            assert torch.equal(p, r["params_end"][n]), n
    for r, at in zip(ranks, [rk["at"] for rk in runs[mesh]]):
        for n in SPLIT:
            c = WIDE // 2
            whole = r["params_end"][n]
            assert torch.equal(r["blocks_end"][n],
                               whole[at[1] * c:(at[1] + 1) * c]), n


@pytest.mark.parametrize("mesh,label", RUNS)
def test_mp_step_collectives(runs, mesh, label):
    """One step's collectives on each rank: over the mp group, one gather
    forward and one input-cotangent sum backward for each split Dense
    call (stage-2's once, the head's two called twice: 5 each); over the
    dp group, as tests/test_torch_dp_step.py counts them at dp = 2 (B6s
    3 + 3, BatchNorm sums forward and backward, two embedding gathers,
    one gradient sum) and none at dp = 1; the permutation's broadcast
    on every mesh."""
    dp = 2 if mesh == "dp2xmp2" else 1
    impl = next(c[1] for c in CASES if c[0] == label)
    bn = 3 + 2 + (3 if impl == "reference" else 0)
    want = {"psum": 6 if dp > 1 and impl == "pair3" else 0,
            "global_moments": 2 * bn if dp > 1 else 0,
            "gather_negatives": 2 if dp > 1 else 0, "all_gather": 0,
            "psum_grads": 1 if dp > 1 else 0, "broadcast": 1, "barrier": 0,
            "cross_replica_mean": 0, "mp_enter": 5, "mp_gather_cols": 5,
            "mp_full": 0}
    for r in runs[label][mesh]:
        assert r["counts"] == want


def test_mp_split_set_matches_jax_param_sharding(runs):
    """The tensors each rank holds as column blocks, and those whose Adam
    moments are blocks, are the ones JAX's ``param_sharding`` places on
    ``P(None, 'mp')`` on the same tree (names through ``convert``),
    and JAX's ``shard_train_state`` rule on its Adam moments."""
    mesh = jax_make_mesh(JaxMeshConfig(dp=4, mp=2))
    specs = param_sharding(mesh, runs["jax_params"])
    flat = jax.tree_util.tree_flatten_with_path(specs)[0]
    jax_split = {".".join([k.key for k in path[:-1]] + ["weight"])
                 for path, s in flat if s.spec == P(None, "mp")}
    assert jax_split == SPLIT
    for mesh_label, _, labels in MESHES:
        for label in labels:
            for r in runs[label][mesh_label]:
                params, moments = r["sharded"]
                assert set(params) == jax_split
                assert set(moments) == jax_split


def test_mp_state_bytes_per_rank(runs):
    """Each rank of mp = 2 holds half of every split weight and of its two
    Adam moments: the one process's bytes less half of theirs."""
    st = runs["pair3"]["one"]["state"]
    whole = sum(p.numel() * 4 for p in st.model.parameters())
    whole += sum(t.numel() * t.element_size() for per in
                 st.optimizer.state.values() for t in per.values())
    split = sum(p.numel() for n, p in st.model.named_parameters()
                if n in SPLIT)
    for r in runs["pair3"]["mp2"]:
        assert r["bytes"] == whole - 3 * split * 4 // 2


def test_mp_checkpoint_is_the_one_process_file_and_restores_anywhere(
        runs, tmp_path):
    """A checkpoint written at init on mp = 2 is, byte for byte, the file
    one process writes from the same weights; one written after two
    steps holds every split tensor whole (the ranks' blocks joined, Adam
    moments too), restores on one process to those values and on mp = 2
    to each rank's blocks."""
    ckpt = runs["ckpt"]
    r0 = runs["pair3"]["mp2"][0]
    cfg = _cfg(PORT, "pair3", "float32")
    tr = Trainer(cfg, steps_per_epoch=10, device="cpu")
    st = tr.init_state(0)
    st.model.load_state_dict(runs["pair3"]["sd"])
    path = save_checkpoint(str(tmp_path), st, 0)
    with open(path, "rb") as f, open(r0["ckpt_init"], "rb") as g:
        assert f.read() == g.read()
    saved = torch.load(r0["ckpt"], weights_only=True)
    for n, t in r0["written"]["model"].items():
        assert torch.equal(saved["model"][n], t), n
    for i, per in r0["written"]["optimizer"]["state"].items():
        for k, t in per.items():
            assert torch.equal(saved["optimizer"]["state"][i][k], t), (i, k)
    one = Trainer(cfg, steps_per_epoch=10, device="cpu").init_state(3)
    restore_checkpoint(r0["ckpt"], one)
    for n, p in one.model.named_parameters():
        assert torch.equal(p.detach(), saved["model"][n]), n
    names = [n for n, _ in one.model.named_parameters()]
    for i, per in saved["optimizer"]["state"].items():
        got = one.optimizer.state[dict(one.model.named_parameters())[
            names[i]]]
        for k, t in per.items():
            assert torch.equal(got[k], t), (names[i], k)
    c = WIDE // 2
    for r, at in zip(runs["pair3"]["mp2"], [rk["at"] for rk in runs["mp2"]]):
        for n, p in r["restored"]["params"].items():
            want = saved["model"][n]
            if n in SPLIT:
                want = want[at[1] * c:(at[1] + 1) * c]
            assert torch.equal(p, want), n
        for n, mom in r["restored"]["moments"].items():
            i = names.index(n)
            for k, t in mom.items():
                want = saved["optimizer"]["state"][i][k]
                if n in SPLIT and k != "step":
                    want = want[at[1] * c:(at[1] + 1) * c]
                assert torch.equal(t, want), (n, k)


# -- MoCo and slow/fast at mp = 2 ------------------------------------------

MOCO_B, SF_B = 8, 16


def _moco_cfg():
    return Config(
        grouping=GroupingConfig(num_centroids=8, knn_k=8, radius_sq=10.0),
        model=ModelConfig(sa_widths=(8, 8, 16), stage2_widths=(16, 32, WIDE),
                          fc_hidden=WIDE, embed_dim=WIDE, num_prototypes=8,
                          sa_impl="pair3", channels_first=True),
        train=TrainConfig(batch_size=MOCO_B,
                          optim=OptimConfig(learning_rate=LR)))


def _sf_cfg():
    """tests/test_torch_slowfast.py's widths, with slow3 ending at 512
    columns and heads of 512 (the Denses the rule splits: slow3's 16->512
    and both heads' two layers)."""
    return Config(
        grouping=GroupingConfig(num_centroids=8, knn_k=8, radius_sq=10.0),
        model=ModelConfig(name="slow_fast", fc_hidden=WIDE, embed_dim=WIDE,
                          slow_widths1=(4, 8, 16), slow_widths3=(16, WIDE),
                          fast_widths1=(8, 16, 32), fast_widths3=(32, 64)),
        train=TrainConfig(batch_size=SF_B,
                          optim=OptimConfig(learning_rate=LR)))


@pytest.fixture(scope="module")
def mocosf():
    rng = np.random.default_rng(3)
    views = torch.from_numpy(rng.normal(size=(2, MOCO_B, N, 4))
                             .astype(np.float32))
    clouds = torch.from_numpy(rng.normal(size=(SF_B, N, 4))
                              .astype(np.float32))
    mcfg = _moco_cfg()
    mtr = MoCoTrainer(mcfg, steps_per_epoch=10, queue_len=2 * MOCO_B,
                      device="cpu")
    mst = mtr.init_state(0, MOCO_B)
    msd = {n: t.clone() for n, t in mst.model.state_dict().items()}
    queue = mst.moco.queue.clone()
    one = {"moco": {"losses": [], "keys": [], "queues": []}}
    for i in range(2):
        mst, m = mtr.step_fn(mst, views)
        one["moco"]["losses"].append(float(m["loss"]))
        if i == 0:
            one["moco"]["grads"] = {n: p.grad.clone() for n, p in
                                    mst.model.named_parameters()
                                    if p.grad is not None}
        one["moco"]["keys"].append({n: t.clone() for n, t in
                                    mst.moco.key_encoder.state_dict()
                                    .items()})
        one["moco"]["queues"].append(mst.moco.queue.clone())
    scfg = _sf_cfg()
    str_ = SlowFastTrainer(scfg, steps_per_epoch=10, slow_k=16, fast_k=8,
                           device="cpu")
    sst = str_.init_state(0)
    ssd = {n: t.clone() for n, t in sst.model.state_dict().items()}
    one["slow_fast"] = {"losses": []}
    for i in range(2):
        sst, m = str_.step_fn(sst, clouds)
        one["slow_fast"]["losses"].append(float(m["loss"]))
        if i == 0:
            one["slow_fast"]["grads"] = {n: p.grad.clone() for n, p in
                                         sst.model.named_parameters()
                                         if p.grad is not None}
    ranks = spawn(mp_moco_slowfast_body, 2, "gloo",
                  args=((1, 2), (mcfg, msd, queue, views),
                        (scfg, ssd, clouds)), timeout_s=300)
    return one, ranks


SF_ABSORBED = tuple(f"{b}.dense_{i}.bias" for b in ("slow1", "fast1",
                                                     "slow3", "fast3")
                    for i in range(3)) + ("head_slow.Dense_0.bias",
                                          "head_fast.Dense_0.bias")


@pytest.mark.parametrize("what", ["moco", "slow_fast"])
def test_mp_moco_and_slowfast_match_one_process(mocosf, what):
    """Two steps at mp = 2: the losses at rtol 2e-4 of one process's and
    equal on both ranks; the first step's gradients before Adam at
    max-abs 2e-4 of each tensor's scale (BN-absorbed biases at 2e-4 of
    the largest gradient) and equal on both ranks. MoCo: the key
    encoder (whole on each rank; its EMA reads the query's gathered
    kernels) and the queue bit-equal across the ranks after each step,
    and within rtol 2e-4 / atol 1e-6 of one process's."""
    one, ranks = mocosf
    want = one[what]
    absorbed = ABSORBED if what == "moco" else SF_ABSORBED
    top = max(float(g.abs().max()) for g in want["grads"].values())
    for r in ranks:
        got = r[what]
        assert got["losses"] == ranks[0][what]["losses"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-4)
        assert set(got["grads"]) == set(want["grads"])
        for n, w in want["grads"].items():
            assert torch.equal(got["grads"][n], ranks[0][what]["grads"][n])
            err = float((got["grads"][n] - w).abs().max()) / top \
                if n.startswith(absorbed) else _max_rel(got["grads"][n], w)
            assert err <= 2e-4, (what, n, err)
        if what == "moco":
            for i in range(2):
                assert torch.equal(got["queues"][i],
                                   ranks[0][what]["queues"][i])
                torch.testing.assert_close(got["queues"][i],
                                           want["queues"][i], rtol=2e-4,
                                           atol=1e-6)
                for n, t in want["keys"][i].items():
                    assert torch.equal(got["keys"][i][n],
                                       ranks[0][what]["keys"][i][n]), n
                    torch.testing.assert_close(got["keys"][i][n], t,
                                               rtol=2e-4, atol=2 * LR)


def test_mp_moco_and_slowfast_collectives_and_split(mocosf):
    """MoCo's query encoder splits as the main encoder: 5 gathers a step,
    and 3 input-cotangent sums, since the head's second call (the global
    rows, which MoCo's loss does not read) takes no cotangent; the key
    encoder, whole, runs none, and its EMA gathers the three split
    kernels (3 ``mp_full``). Slow/fast splits slow3's last Dense and both
    heads' two: 5 Denses, each called once, 5 gathers and 5 sums."""
    _, ranks = mocosf
    for r in ranks:
        m, s = r["moco"]["counts"], r["slow_fast"]["counts"]
        assert (m["mp_gather_cols"], m["mp_enter"], m["mp_full"]) == \
            (5, 3, 3)
        assert (s["mp_gather_cols"], s["mp_enter"], s["mp_full"]) == \
            (5, 5, 0)
        assert set(r["slow_fast"]["sharded"]) == {
            "slow3.dense_1.weight", "head_slow.Dense_0.weight",
            "head_slow.Dense_1.weight", "head_fast.Dense_0.weight",
            "head_fast.Dense_1.weight"}


# -- the mesh and the mp collectives ------------------------------------

@pytest.fixture(scope="module")
def collective_runs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 3, generator=g, dtype=torch.float64)
    w = torch.randn(3, 8, generator=g, dtype=torch.float64)
    return x, w, spawn(mp_collectives_body, 4, "gloo", args=((2, 2), x, w),
                       timeout_s=120)


def test_mesh_lays_ranks_out_as_jax_lays_devices(collective_runs):
    """Rank r at (r // mp, r % mp), as JAX's ``devices.reshape(dp, mp)``:
    the dp group is the ranks of one column, the mp group those of one
    row, each rank's batch block is its row's."""
    jax_mesh = jax_make_mesh(JaxMeshConfig(dp=2, mp=2),
                             devices=jax.devices()[:4])
    layout = [[d.id for d in row] for row in jax_mesh.devices]
    _, _, ranks = collective_runs
    for r, out in enumerate(ranks):
        d, m = out["at"]
        assert layout[d][m] == r == out["global_rank"]
        assert out["shape"] == {"dp": 2, "mp": 2}
        assert out["members"] == [[layout[e][m] for e in range(2)],
                                  layout[d]]
        assert out["slice"] == slice(4 * d, 4 * d + 4)
        assert out["lead"] == (r == 0)


def test_mp_collectives_compute_the_whole_gemm(collective_runs):
    """The column-parallel GEMM on two mp ranks: its output the whole
    product on every rank; the input gradient the whole one (the mp sum);
    each rank's block gradient its columns of the whole one (no sum);
    ``mp_full`` the whole kernel; one call each."""
    x, w, ranks = collective_runs
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = xr @ wr
    (y * y).sum().backward()
    for out in ranks:
        m = out["at"][1]
        torch.testing.assert_close(out["y"], y.detach(), rtol=1e-14,
                                   atol=0)
        torch.testing.assert_close(out["dx"], xr.grad, rtol=1e-12, atol=0)
        torch.testing.assert_close(out["dw"], wr.grad[:, 4 * m:4 * m + 4],
                                   rtol=1e-12, atol=0)
        assert torch.equal(out["full"], w.T)
        assert (out["counts"]["mp_enter"], out["counts"]["mp_gather_cols"],
                out["counts"]["mp_full"]) == (1, 1, 1)
