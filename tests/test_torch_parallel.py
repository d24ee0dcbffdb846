"""The port's data-parallel layer (facl_tpu_torch/parallel) on the CPU:
``make_mesh`` against facl_tpu/parallel/mesh.py's rules, ``initialize`` as
a no-op for one process and its refusal of NCCL without a card a rank,
every collective's values and gradients across two gloo ranks (float64,
held against the one-process computation of the same function), and the
launcher that the data-parallel tests and chip_smoke.py start ranks with:
it raises a failing rank's traceback and kills a rank that hangs, within
its deadline."""
import time

import pytest
import torch
import torch.distributed as dist

from facl_tpu.config import MeshConfig as JaxMeshConfig
from facl_tpu.parallel import make_mesh as jax_make_mesh
from facl_tpu_torch.config import MeshConfig
from facl_tpu_torch.parallel import COLLECTIVES, Mesh, batch_slice, \
    gather_negatives, global_moments, initialize, make_mesh, psum, \
    psum_packed, spawn
from tests.torch_dp_ranks import collectives_body, fail_on_rank_1, \
    hang_in_collective


def test_make_mesh_follows_the_jax_rules():
    # JAX's mesh over its 8 CPU devices: dp=-1 takes all of them.
    assert jax_make_mesh(JaxMeshConfig()).shape["dp"] == 8
    mesh = make_mesh(MeshConfig())                 # dp=-1: every rank
    assert (mesh.dp, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.shape == {"dp": 1, "mp": 1}
    assert make_mesh(MeshConfig(dp=1)).dp == 1
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        make_mesh(MeshConfig(dp=2))
    with pytest.raises(ValueError, match="mesh 1x2 needs 2 ranks, have 1"):
        make_mesh(MeshConfig(dp=1, mp=2))


def test_batch_slice_is_the_dp_sharding_of_the_batch_axis():
    assert batch_slice(None, 8) == slice(0, 8)
    assert [batch_slice(Mesh(dp=4, rank=r), 8) for r in range(4)] == \
        [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="does not divide"):
        batch_slice(Mesh(dp=3, rank=0), 8)


def test_initialize_is_a_noop_for_one_process(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert initialize("nccl") is False and initialize("gloo") is False
    assert not dist.is_initialized()
    before = [c.calls for c in COLLECTIVES]
    x = torch.randn(4, 3, requires_grad=True)
    for mesh in (None, make_mesh()):
        assert psum(x, mesh) is x
        assert gather_negatives(x, mesh) is x
        assert psum_packed([x], mesh)[0] is x
        mean, var = global_moments(x, mesh)
        assert torch.equal(mean, x.mean(0))
        assert torch.equal(var, ((x * x).mean(0) - mean * mean).clamp_min(0))
    assert [c.calls for c in COLLECTIVES] == before


def test_nccl_with_fewer_cards_than_ranks_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="nccl needs one CUDA device"):
        initialize("nccl", init_method=f"file://{tmp_path}/store", rank=0,
                   world_size=cards + 1)
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def two_ranks():
    g = torch.Generator().manual_seed(0)
    xs = torch.randn(6, 3, generator=g, dtype=torch.float64)
    w = torch.randn(6, 3, generator=g, dtype=torch.float64)
    return xs, w, spawn(collectives_body, 2, "gloo", args=(xs, w),
                        timeout_s=120)


def test_collectives_values_across_two_ranks(two_ranks):
    xs, w, ranks = two_ranks
    for r, out in enumerate(ranks):
        assert (out["rank"], out["dp"]) == (r, 2)
        assert torch.equal(out["psum"], torch.full((3,), 3.0,
                                                   dtype=torch.float64))
        a, b = out["packed"]
        assert a.dtype == torch.float32 and b.dtype == torch.float64
        assert torch.equal(a, torch.ones(2, 2))
        assert torch.equal(b, torch.full((3,), 2.0, dtype=torch.float64))
        assert torch.equal(out["gathered"], xs)       # exact, rank order
        assert torch.equal(out["all_gather"], xs * 2)
        assert torch.equal(out["psum_grads"], torch.full((2,), 3.0))
        assert torch.equal(out["broadcast"], torch.full((2,), 7.0))
        assert torch.equal(out["mean_over_ranks"], torch.tensor([0.5]))
        mean, var = out["moments"]
        torch.testing.assert_close(mean, xs.mean(0), rtol=1e-12, atol=0)
        torch.testing.assert_close(var, xs.var(0, unbiased=False),
                                   rtol=1e-12, atol=0)
        # Forward and backward of the moments' sum; everything else once.
        assert out["counts"] == {
            "psum": 2, "global_moments": 2, "gather_negatives": 1,
            "all_gather": 1, "psum_grads": 1, "broadcast": 1,
            "barrier": 1, "cross_replica_mean": 1}


def test_collectives_gradients_across_two_ranks(two_ranks):
    """gather_negatives: this rank's block differentiable, the others
    detached, so each rank's gradient is its own block of w.
    global_moments: the ranks' gradients of their rows' share of the loss
    together equal the one-process gradient of the whole loss."""
    xs, w, ranks = two_ranks
    for r, out in enumerate(ranks):
        assert torch.equal(out["gather_grad"], w[3 * r:3 * r + 3])
    x = xs.clone().requires_grad_()
    mean = x.mean(0)
    var = ((x * x).mean(0) - mean * mean).clamp_min(0)
    ((x - mean) * torch.rsqrt(var + 1e-5) * w).sum().backward()
    got = torch.cat([out["moments_grad"] for out in ranks])
    torch.testing.assert_close(got, x.grad, rtol=1e-10, atol=1e-12)


def test_launcher_raises_the_failing_ranks_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as e:
        spawn(fail_on_rank_1, 2, "gloo", timeout_s=60)
    msg = str(e.value)
    assert "rank 1 of 2 failed" in msg
    assert "ValueError: rank 1 failed on purpose" in msg
    assert "fail_on_rank_1" in msg                  # the traceback itself
    assert time.monotonic() - t0 < 60


def test_launcher_kills_a_rank_that_hangs():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"still running after 8 s"):
        spawn(hang_in_collective, 2, "gloo", timeout_s=8)
    assert time.monotonic() - t0 < 20
    assert not dist.is_initialized()
