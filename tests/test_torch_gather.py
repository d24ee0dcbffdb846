"""Kernel B5 (row gather and its scatter-add transpose) of the PyTorch port
against the JAX package's TPU kernels in interpret mode
(facl_tpu/ops/pallas/gather.py). On the CPU the port runs the kernels'
plain twins. The gather is a copy, so it must be EQUAL; the scatter-add
and the gradient through the gather are held at the bars of
tests/test_pallas_gather.py (atol 1e-5 and 1e-4: the TPU contracts a
one-hot matrix, the twin adds rows)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from facl_tpu.ops.pallas.gather import gather_rows as jax_gather_rows
from facl_tpu.ops.pallas.gather import gather_rows_vjp as jax_gather_vjp
from facl_tpu.ops.pallas.gather import scatter_add_rows as jax_scatter
from facl_tpu_torch.ops.gather import gather_rows, gather_rows_vjp, \
    scatter_add_rows


def test_gather_rows_equals_tpu_kernel(rng):
    B, N, C, R = 4, 128, 4, 256
    table = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, R)).astype(np.int32)
    out = jax_gather_rows(jnp.asarray(table), jnp.asarray(idx),
                          interpret=True)
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(out))


@pytest.mark.parametrize("N", [64, 5])      # 5: every point hit many times
def test_scatter_add_rows_matches_tpu_kernel(rng, N):
    B, C, R = 3, 4, 128
    idx = rng.integers(0, N, size=(B, R)).astype(np.int32)
    g = rng.normal(size=(B, R, C)).astype(np.float32)
    out = jax_scatter(jnp.asarray(idx), jnp.asarray(g), N, interpret=True)
    got = scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(g), N)
    assert tuple(got.shape) == (B, N, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=1e-5)


def _idx(rng, B, N, R, dist):
    """(B, R) int32 indices: uniform over the N points, or skewed as on the
    padded clouds of the main path, where 64 centroid points own ~90% of
    the rows."""
    if dist == "uniform":
        return rng.integers(0, N, size=(B, R)).astype(np.int32)
    hot = rng.choice(N, size=min(64, N), replace=False)
    return np.where(rng.random((B, R)) < 0.9, rng.choice(hot, size=(B, R)),
                    rng.integers(0, N, size=(B, R))).astype(np.int32)


# The shapes the card kernels branch on: C % 4 (16-byte rows or scalar
# channels, C = 8 in two 4-channel passes of B5b), few or many points.
SHAPES = [(C, N, "uniform") for C in (1, 3, 4, 8) for N in (5, 512)] + \
    [(C, 512, "skewed") for C in (1, 3, 4, 8)]


@pytest.mark.parametrize("C,N,dist", SHAPES)
def test_gather_rows_shapes_equal_tpu_kernel(rng, C, N, dist):
    B, R = 1, 4096
    table = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = _idx(rng, B, N, R, dist)
    out = jax_gather_rows(jnp.asarray(table), jnp.asarray(idx),
                          interpret=True)
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(out))


@pytest.mark.parametrize("C,N,dist", SHAPES)
def test_scatter_add_rows_shapes_match_tpu_kernel(rng, C, N, dist):
    B, R = 1, 4096
    idx = _idx(rng, B, N, R, dist)
    g = rng.normal(size=(B, R, C)).astype(np.float32)
    out = np.asarray(jax_scatter(jnp.asarray(idx), jnp.asarray(g), N,
                                 interpret=True))
    got = scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(g), N)
    assert tuple(got.shape) == (B, N, C)
    # With N = 5 each point sums ~800 rows to a magnitude of ~30; two f32
    # summation orders then differ by ~1e-5 of that scale.
    np.testing.assert_allclose(got.numpy(), out,
                               atol=1e-5 * max(1.0, np.abs(out).max()))


def test_gather_vjp_grad_matches_jax(rng):
    B, N, C, R = 2, 64, 4, 128
    table = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, R)).astype(np.int32)
    gj = jax.grad(lambda t: jnp.sum(
        jax_gather_vjp(t, jnp.asarray(idx), True) ** 2))(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    (gather_rows_vjp(tt, torch.from_numpy(idx)) ** 2).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(gj), atol=1e-4)


def test_scatter_add_is_the_gather_transpose(rng):
    """<gather(t), g> == <t, scatter(g)> for any t, g: the two are adjoint."""
    B, N, C, R = 2, 16, 3, 40
    t = torch.from_numpy(rng.normal(size=(B, N, C)))
    g = torch.from_numpy(rng.normal(size=(B, R, C)))
    idx = torch.from_numpy(rng.integers(0, N, size=(B, R)).astype(np.int32))
    lhs = (gather_rows(t, idx) * g).sum()
    rhs = (t * scatter_add_rows(idx, g, N)).sum()
    assert abs(float(lhs - rhs)) < 1e-9 * max(1.0, abs(float(lhs)))
