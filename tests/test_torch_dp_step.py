"""The port's data-parallel train step on two gloo ranks on the CPU (the
kernels' twins), against the JAX package's UNSHARDED step from the same
weights (``convert.from_jax``), on the same points (each rank takes its
block of the batch) and circle permutation, on tests/test_sharding.py's
``tiny_config`` models: ``pair3``, ``pair``, ``reference``, ``covar`` and
``analytic`` in f32 and in bf16.

Bars. f32 against JAX, those of tests/test_sharding.py:34-71,183-266:
the loss at rtol 2e-4, the parameters after the first Adam step at rtol
5e-3 / atol 2 lr, the BatchNorm running statistics at rtol 1e-3 / atol
1e-5. bf16 against JAX, the JAX package's bf16 bars
(tests/test_torch_bf16_step.py): loss rtol 5e-2, running statistics rtol =
atol = 5e-2; and bf16 against the port's own one-process bf16 step at
tests/test_sharding.py's bars. Every case: the gradients before Adam
against the port's one-process step at normalised max-abs 2e-4 in f32 and
2^-7 in bf16 (test_dp_gradients_match_one_process says why; a doubled or
a missing sum over the ranks fails either, where Adam's scale-invariant
first step would hide it), the two ranks' loss and gradients equal, their
parameters bit-equal after three steps, and the collectives of one step
counted. At bf16 also: the two ranks' loss and running statistics
bit-equal to one process rounding as two ranks do
(tests/torch_two_halves.py, which also runs the pair stage as two ranks
in two threads, its all-reduces summing the threads' buffers). Also: the impls
without a data-parallel form (hybrid, hybrid2, pallas: JAX does not
partition them either) raise under dp = 2, and ``split_step`` raises
under dp = 2 and runs the same step on one process."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu.config import Config as JaxConfig
from facl_tpu.config import GroupingConfig as JaxGroupingConfig
from facl_tpu.config import ModelConfig as JaxModelConfig
from facl_tpu.config import OptimConfig as JaxOptimConfig
from facl_tpu.config import TrainConfig as JaxTrainConfig
from facl_tpu.train import Trainer as JaxTrainer
from facl_tpu_torch.config import Config, GroupingConfig, ModelConfig, \
    OptimConfig, TrainConfig
from facl_tpu_torch.convert import from_jax
from facl_tpu_torch.parallel import spawn
from facl_tpu_torch.train import Trainer
from tests.torch_dp_ranks import dp_rejects_body, dp_step_body
from tests.torch_two_halves import as_two_halves

G, B, N, C = 4, 8, 32, 4
LR = 1e-3
STEPS = 3
#: (label, sa_impl, compute dtype, SA widths): tiny_config's (8, 16), or
#: the (8, 8, 16) of the pair impls (L = 3, test_sharding.py:229-232).
CASES = (("pair3", "pair3", "float32", (8, 8, 16)),
         ("pair", "pair", "float32", (8, 8, 16)),
         ("reference", "reference", "float32", (8, 16)),
         ("pair3 bf16", "pair3", "bfloat16", (8, 8, 16)),
         ("pair bf16", "pair", "bfloat16", (8, 8, 16)),
         ("reference bf16", "reference", "bfloat16", (8, 16)),
         ("covar", "covar", "float32", (8, 16)),
         ("analytic", "analytic", "float32", (8, 16)),
         ("covar bf16", "covar", "bfloat16", (8, 16)),
         ("analytic bf16", "analytic", "bfloat16", (8, 16)))
ABSORBED = ("sa_stage.bias_", "stage2_mlp.dense_0.bias",
            "stage2_mlp.dense_1.bias", "head.Dense_0.bias")


def _cfg(ns, impl, dtype, widths, **train):
    """tests/test_sharding.py::tiny_config in the package ``ns``'s
    classes, with the SA impl, dtype and widths of a case."""
    cfg_cls, g_cls, m_cls, t_cls, o_cls = ns
    return cfg_cls(
        grouping=g_cls(num_centroids=8, knn_k=8, radius_sq=10.0),
        model=m_cls(sa_widths=widths, stage2_widths=(16, 32), fc_hidden=32,
                    embed_dim=16, num_prototypes=8, num_crops=G,
                    sa_impl=impl, channels_first=impl in ("pair", "pair3"),
                    compute_dtype=dtype),
        train=t_cls(batch_size=B, optim=o_cls(learning_rate=LR), **train))


JAX = (JaxConfig, JaxGroupingConfig, JaxModelConfig, JaxTrainConfig,
       JaxOptimConfig)
PORT = (Config, GroupingConfig, ModelConfig, TrainConfig, OptimConfig)


def _one_process(cfg, sd, points, perm, halves=False):
    """The one-process step; with ``halves``, rounding as two ranks do
    (tests/torch_two_halves.py)."""
    tr = Trainer(cfg, steps_per_epoch=10, device="cpu")
    st = tr.init_state(0)
    st.model.load_state_dict(sd)
    with as_two_halves() if halves else contextlib.nullcontext():
        st, m = tr.step_fn(st, points, perm=perm)
    return dict(loss=float(m["loss"]),
                grads={n: p.grad.clone() for n, p in
                       st.model.named_parameters() if p.grad is not None},
                params={n: p.detach().clone() for n, p in
                        st.model.named_parameters()},
                buffers={n: b.clone() for n, b in st.model.named_buffers()})


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    points = rng.normal(size=(G, B, N, C)).astype(np.float32)
    key, ep = jax.random.PRNGKey(1), jnp.asarray(0)
    perm = torch.tensor(np.asarray(
        jax.random.permutation(jax.random.split(key)[1], G)))
    out, cases = {}, []
    for label, impl, dtype, widths in CASES:
        jt = JaxTrainer(_cfg(JAX, impl, dtype, widths), steps_per_epoch=10)
        js = jt.init_state(jax.random.PRNGKey(0), jnp.asarray(points))
        sd = from_jax(jax.tree_util.tree_map(np.asarray, js.params),
                      jax.tree_util.tree_map(np.asarray, js.batch_stats))
        js, jm = jt.step_fn(js, jnp.asarray(points), key, ep)
        cfg = _cfg(PORT, impl, dtype, widths)
        out[label] = dict(
            jax=dict(loss=float(jm["loss"]),
                     params=from_jax(jax.tree_util.tree_map(
                         np.asarray, js.params), {}),
                     buffers=from_jax({}, jax.tree_util.tree_map(
                         np.asarray, js.batch_stats))),
            one=_one_process(cfg, sd, torch.from_numpy(points), perm))
        if dtype == "bfloat16":
            out[label]["halves"] = _one_process(
                cfg, sd, torch.from_numpy(points), perm, halves=True)
        cases.append((label, cfg, sd))
    ranks = spawn(dp_step_body, 2, "gloo",
                  args=(cases, torch.from_numpy(points), perm, STEPS),
                  timeout_s=300)
    for label in out:
        out[label]["ranks"] = [r[label] for r in ranks]
    return out


def _assert_states(got, want, rtol_s, atol_s, name):
    for n, w in want["params"].items():
        np.testing.assert_allclose(got["params"][n].numpy(), w.numpy(),
                                   rtol=5e-3, atol=2 * LR,
                                   err_msg=f"{name}: {n}")
    for n, w in want["buffers"].items():
        np.testing.assert_allclose(got["buffers"][n].numpy(), w.numpy(),
                                   rtol=rtol_s, atol=atol_s,
                                   err_msg=f"{name}: {n}")


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_dp_step_matches_jax_unsharded(runs, label):
    run = runs[label]
    r0, r1 = run["ranks"]
    assert r0["loss"] == r1["loss"]           # the global loss on each rank
    if "bf16" in label:
        np.testing.assert_allclose(r0["loss"], run["jax"]["loss"],
                                   rtol=5e-2)
        for n, w in run["jax"]["buffers"].items():
            np.testing.assert_allclose(r0["buffers"][n].numpy(), w.numpy(),
                                       rtol=5e-2, atol=5e-2, err_msg=n)
        np.testing.assert_allclose(r0["loss"], run["one"]["loss"],
                                   rtol=2e-4)
        _assert_states(r0, run["one"], 1e-3, 1e-5, label)
    else:
        np.testing.assert_allclose(r0["loss"], run["jax"]["loss"],
                                   rtol=2e-4)
        _assert_states(r0, run["jax"], 1e-3, 1e-5, label)


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_dp_gradients_match_one_process(runs, label):
    """The gradients before Adam, summed over the ranks (the pair stage's
    already global), against the one-process step's: max-abs over each
    tensor's scale at most 2e-4 in f32. At bf16 a bf16 Dense's weight
    gradient is rounded to bf16 where autograd forms it (as JAX's is), on
    each rank before the sum and once on one process: the two differ by up
    to one bf16 rounding of each rank's part, so the bar is 2^-7 (two
    halves of a bf16 ulp at the tensor's scale); a doubled or a missing
    sum is off by 100% or 50%. The BN-absorbed biases, whose exact
    gradient is zero, carry round-off alone: their difference is held at
    the same bar of the largest gradient."""
    run = runs[label]
    bar = 2.0 ** -7 if "bf16" in label else 2e-4
    r0, r1 = run["ranks"]
    one = run["one"]["grads"]
    assert set(r0["grads"]) == set(one)
    top = max(float(g.abs().max()) for g in one.values())
    for n, want in one.items():
        got = r0["grads"][n]
        assert torch.equal(got, r1["grads"][n]), n
        scale = top if n.startswith(ABSORBED) else \
            max(float(want.abs().max()), 1e-30)
        err = float((got - want).abs().max()) / scale
        assert err <= bar, (n, err)


@pytest.mark.parametrize("label", [c[0] for c in CASES
                                   if c[2] == "bfloat16"])
def test_dp_bf16_matches_one_process_as_two_halves(runs, label):
    """The two ranks' bf16 step against one process rounding as the two
    ranks do (tests/torch_two_halves.py: each Dense GEMM and BatchNorm
    sum split by halves, and the pair stage run as two ranks in two
    threads, its all-reduces summing their buffers): the loss and the
    running statistics equal. One process on the whole batch rounds
    otherwise, and at bf16 a rounding moves a value by 2^-8 of itself; the
    witness shows that the two ranks compute what one process computes up
    to those roundings."""
    run = runs[label]
    want = run["halves"]
    for r in run["ranks"]:
        assert r["loss"] == want["loss"]
        for n, w in want["buffers"].items():
            assert torch.equal(r["buffers"][n], w), n


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_dp_ranks_stay_bit_equal(runs, label):
    r0, r1 = runs[label]["ranks"]
    for n, p in r0["params_end"].items():
        assert torch.equal(p, r1["params_end"][n]), n


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_dp_step_collectives(runs, label):
    """One step's collectives on each rank: the B6s sums of the pair stage
    (pair3 3 + 3, pair 3 + 2) and analytic's backward sums (one a layer),
    the BatchNorm moment sums forward and backward (stage-2's two layers,
    the head's one layer called twice, and the reference and covar SA's
    layers, but for covar's first Gram, of the input, which takes no
    cotangent; analytic's forward only, inside its Function), the two
    gathers of the embeddings, one broadcast of the circle permutation
    and one gradient sum."""
    impl, widths = next((c[1], c[3]) for c in CASES if c[0] == label)
    sa = {"reference": 2 * len(widths), "covar": 2 * len(widths) - 1,
          "analytic": len(widths)}.get(impl, 0)
    bn = 2 * (2 + 2) + sa
    want = {"psum": {"pair3": 6, "pair": 5,
                     "analytic": len(widths)}.get(impl, 0),
            "global_moments": bn, "gather_negatives": 2,
            "all_gather": 0, "psum_grads": 1, "broadcast": 1, "barrier": 0,
            "cross_replica_mean": 0}
    for r in runs[label]["ranks"]:
        assert r["counts"] == want


def test_dp_rejects_impls_without_a_dp_form_and_split_step():
    cfgs = [(impl, _cfg(PORT, impl, "float32", (8, 8, 16)))
            for impl in ("hybrid", "hybrid2", "pallas")]
    cfgs.append(("split_step", _cfg(PORT, "pair3", "float32", (8, 8, 16),
                                    split_step=True)))
    out = spawn(dp_rejects_body, 2, "gloo", args=(cfgs,), timeout_s=120)
    for rank in out:
        for label, exc, msg in rank:
            if label == "split_step":
                assert exc == "ValueError" and "split_step" in msg
            else:
                assert exc == "NotImplementedError" and \
                    "JAX does not partition it either" in msg and \
                    "'covar', 'analytic'" in msg, (label, exc, msg)


def test_split_step_runs_the_same_step_on_one_process():
    rng = np.random.default_rng(1)
    points = torch.from_numpy(rng.normal(size=(G, B, N, C))
                              .astype(np.float32))
    perm = torch.randperm(G, generator=torch.Generator().manual_seed(0))
    outs = []
    for split in (False, True):
        cfg = _cfg(PORT, "pair3", "float32", (8, 8, 16), split_step=split)
        tr = Trainer(cfg, steps_per_epoch=10, device="cpu")
        st = tr.init_state(0)
        st, m = tr.step_fn(st, points, perm=perm)
        outs.append((float(m["loss"]), {n: p.detach().clone() for n, p in
                                        st.model.named_parameters()}))
    assert outs[0][0] == outs[1][0]
    for n, p in outs[0][1].items():
        assert torch.equal(p, outs[1][1][n]), n
