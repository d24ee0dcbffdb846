"""One process that rounds as data-parallel or tensor-parallel ranks do:
the witnesses that tests/test_torch_dp_step.py, test_torch_mp_step.py and
chip_smoke.py's phase 7 hold the ranks' train step against. This module
imports torch and the port only (no JAX).

Under ``as_two_halves()`` (two dp ranks):

- each stage-2 and head Dense GEMM and each reference SA layer's GEMM
  runs as two calls, one on each half of its rows (the rows a rank
  holds);
- each BatchNorm moment sum is taken over each half, then added
  (``global_moments`` over two ranks), and so is covar's Gram and column
  sum (``global_gram``);
- analytic's backward sums (A, u, Gram and colsum of each layer) are
  taken over each half and added in float64, as its ``psum_packed``
  adds the ranks' buffers;
- the pair/pair3 stage (``ops/sa_pair.py::_Pair``, f32 and bf16) runs as
  B6s runs it on two ranks: each half of the clouds in a thread of its
  own with a mesh of two, and each ``psum_packed`` of the stage sums the
  two threads' float64 buffers at a barrier, in place of the all_reduce
  (``collectives._all_reduce``). The stage's own code, its packing and
  the finalize of the float64 sums run unchanged.

Under ``as_column_blocks(mp)`` (``mp`` tensor-parallel ranks): each Dense
that the mp rule splits (``parallel.mesh.mp_sharded``) runs as ``mp``
GEMMs, one on each block of its output columns, joined along the last
axis before its bias is added, as ``ColumnDense`` runs on the ranks; the
input's cotangent is then the sum of the blocks' parts, as ``mp_enter``
sums it. Entered outside ``as_two_halves()``, each half runs its column
blocks: the ranks of a dp x mp mesh.
"""
import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from facl_tpu_torch.models import layers, sa_stage
from facl_tpu_torch.ops import analytic_sa, fused_sa
from facl_tpu_torch.ops import sa_pair as SP
from facl_tpu_torch.parallel import collectives
from facl_tpu_torch.parallel.mesh import Mesh, mp_sharded


def halves(x):
    """The two ranks' blocks of rows ``x`` (dim 0)."""
    return x[:x.shape[0] // 2], x[x.shape[0] // 2:]


class _Exchange:
    """The all_reduce of two threads: each puts its buffer in its rank's
    slot, and both read the sum once both are in."""

    def __init__(self):
        self.slots = [None, None]
        self.barrier = threading.Barrier(2, timeout=600)

    def all_reduce(self, t, mesh):
        self.slots[mesh.rank] = t
        self.barrier.wait()
        out = self.slots[0] + self.slots[1]
        self.barrier.wait()     # both have read before a slot is reused
        return out


def _two_ranks(fn):
    """[fn(mesh) for the two ranks], each in a thread of its own (grad
    mode off, as in an autograd Function's forward and backward), meeting
    at each all_reduce of the stage."""
    ex = _Exchange()

    def rank(r):
        try:
            with torch.no_grad():
                return fn(Mesh(dp=2, rank=r, group=ex))
        except BaseException:
            ex.barrier.abort()   # the other rank stops waiting and raises
            raise

    saved = collectives._all_reduce
    collectives._all_reduce = lambda t, mesh: mesh.group.all_reduce(t, mesh)
    try:
        with ThreadPoolExecutor(2) as pool:
            futures = [pool.submit(rank, r) for r in range(2)]
            return [f.result() for f in futures]
    finally:
        collectives._all_reduce = saved


class _PairAsTwoRanks(torch.autograd.Function):
    """``sa_pair._Pair`` with each half of the clouds on a rank of its
    own: pooled rows joined in rank order; the statistics and the
    parameter gradients, global on both ranks, taken from rank 0 once
    they are found bit-equal on rank 1."""

    @staticmethod
    def forward(ctx, x_cf, eps, slim, dtype, mesh, *flat):
        lps = [SP.SALayerParams(*flat[4 * i:4 * i + 4]) for i in range(3)]
        Bv, C0, S, K = x_cf.shape
        x3 = halves(x_cf.reshape(Bv, C0, S * K))
        outs = _two_ranks(lambda m: SP.sa_forward_pair(
            x3[m.rank], lps, K, eps, dtype, m))
        stats = [[t for s in o[1] for t in s] for o in outs]
        if not all(torch.equal(a, b) for a, b in zip(*stats)):
            raise AssertionError("the two ranks' statistics differ")
        ctx.args = (x3, lps, outs, K, eps, slim, dtype, x_cf.shape)
        ctx.mark_non_differentiable(*stats[0])
        return (torch.cat([o[0] for o in outs]).reshape(Bv, S, -1),
                *stats[0])

    @staticmethod
    def backward(ctx, dpooled, *_):
        x3, lps, outs, K, eps, slim, dtype, shape = ctx.args
        dp = halves(dpooled.reshape(-1, dpooled.shape[-1]))
        grads = _two_ranks(lambda m: SP.sa_backward_pair(
            x3[m.rank], lps, outs[m.rank][1], outs[m.rank][2], dp[m.rank],
            K, eps, slim, dtype, m))
        flat = [[g for lp in gr for g in lp] for gr in grads]
        if not all(torch.equal(a, b) for a, b in zip(*flat)):
            raise AssertionError("the two ranks' gradients differ")
        return (torch.zeros(shape, dtype=x3[0].dtype, device=x3[0].device),
                None, None, None, None, *flat[0])


def _moments(flat, mesh):
    """``global_moments`` over two ranks' halves of ``flat``."""
    C, n = flat.shape[-1], flat.shape[0]
    s = sum(torch.cat([h.sum(0), (h * h).sum(0)]) for h in halves(flat))
    mean = s[:C] / n
    return mean, (s[C:] / n - mean * mean).clamp_min(0.0)


def _gram(flat, mesh):
    """``global_gram`` over two ranks' halves of ``flat``."""
    C = flat.shape[-1]
    s = sum(torch.cat([(h.T @ h).reshape(-1), h.sum(0)])
            for h in halves(flat))
    return s[:C * C].view(C, C), s[C * C:]


_LAYER_SUMS = analytic_sa._layer_sums


def _layer_sums(dy, h_prev, mesh):
    """analytic's ``_layer_sums`` over two ranks' halves: each half's
    sums, added in float64 and rounded back, as ``psum_packed`` does."""
    parts = [_LAYER_SUMS(d, h, None) for d, h in zip(halves(dy),
                                                      halves(h_prev))]
    return [(a.double() + b.double()).to(a.dtype) for a, b in zip(*parts)]


@contextlib.contextmanager
def as_two_halves():
    """The port's train step, for the block, rounding as two ranks do
    (module docstring)."""
    dense, sa_dense, moments0, pair, gram0, sums0 = (
        layers.apply_dense, fused_sa._dense, layers.global_moments,
        SP._Pair, sa_stage.global_gram, analytic_sa._layer_sums)
    layers.apply_dense = lambda lin, x, dtype=torch.float32: torch.cat(
        [dense(lin, h, dtype) for h in halves(x)])
    fused_sa._dense = lambda h, lp, dtype: torch.cat(
        [sa_dense(x, lp, dtype) for x in halves(h)])
    layers.global_moments = fused_sa.global_moments = _moments
    sa_stage.global_gram, analytic_sa._layer_sums = _gram, _layer_sums
    SP._Pair = _PairAsTwoRanks
    try:
        yield
    finally:
        layers.apply_dense, fused_sa._dense, SP._Pair = dense, sa_dense, pair
        layers.global_moments = fused_sa.global_moments = moments0
        sa_stage.global_gram, analytic_sa._layer_sums = gram0, sums0


@contextlib.contextmanager
def as_column_blocks(mp: int = 2):
    """The port's step, for the block, computing each split Dense as
    ``mp`` column-block GEMMs (module docstring)."""
    dense = layers.apply_dense
    rule = Mesh(dp=1, mp=mp)

    def split(lin, x, dtype=torch.float32):
        if not mp_sharded(rule, (lin.in_features, lin.out_features)):
            return dense(lin, x, dtype)
        bf = dtype == torch.bfloat16
        xb = x.to(dtype) if bf else x
        w = lin.weight.to(dtype) if bf else lin.weight
        c = lin.out_features // mp
        y = torch.cat([torch.nn.functional.linear(xb, w[k * c:(k + 1) * c])
                       for k in range(mp)], dim=-1)
        if lin.bias is None:
            return y
        return y + (lin.bias.to(dtype) if bf else lin.bias)
    layers.apply_dense = split
    try:
        yield
    finally:
        layers.apply_dense = dense
