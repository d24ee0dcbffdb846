"""The port's bf16 SA paths (``compute_dtype="bfloat16"``) against the JAX
package at bf16: the five bf16 sweep twins of pair3 (kernels B2a, B2b,
B3a, B3b, B3c on the card) against the outputs of the JAX sweeps they
port, run in interpret mode on the same inputs; the pair3 and reference
stages, train and eval, against the JAX stage at bf16; the row
references of ops/fused_sa.py at bf16; and the impls that have no bf16
form yet.

Tolerances:
  * sweep twins vs the JAX sweeps, fed the JAX side's own inputs: the
    bf16 row outputs (p2, max, min, q3, mq) differ on at most 1% of their
    entries and there by at most one bf16 ulp (2^-7 of the value); pool
    indices equal; f32 accumulators within 1e-5 of their max-abs (only
    the order of f32 sums of exact bf16 products differs);
  * stages: outputs and BatchNorm statistics at rtol = atol = 5e-2
    (tests/test_covar_bn.py:38-39, the JAX package's bf16 bar); gradients
    at relative L2 < 0.15 and cosine > 0.99 (tests/test_sa_pair.py:
    109-135), the Dense biases (zero under BatchNorm) skipped;
  * and one stricter bar: the port's bf16 gradients lie no farther from
    float64 than twice the JAX package's bf16 gradients do (relative L2
    over all compared gradients together).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import facl_tpu.ops.pallas.sa_pair as jsp
from facl_tpu.models.sa_stage import SetAbstractionStage as JaxStage
from facl_tpu.ops.pallas.sa_bwd import _fold_affine as jax_fold_affine
from facl_tpu.ops.pallas.sa_bwd import _layer_terms as jax_layer_terms
from facl_tpu_torch.convert import from_jax
from facl_tpu_torch.models.sa_stage import IMPLS, SetAbstractionStage
from facl_tpu_torch.ops import sa_pair as SP
from tests.test_analytic_sa import make_layers

EPS = 1e-5
B, C0, S, K = 2, 4, 4, 8
WIDTHS = (8, 8, 16)
C1, C2, C3 = WIDTHS
BF = jnp.bfloat16


class _Recorder:
    """Stands in for ``jax.experimental.pallas`` in the JAX sa_pair module:
    every pallas_call's outputs are appended to ``store``, in call order."""

    def __init__(self, store):
        self.store = store

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, *a, **k):
        f = pl.pallas_call(*a, **k)

        def run(*args):
            out = f(*args)
            self.store.append(out)
            return out
        return run


def _t(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


def _unpair(a, c):
    """Paired (R/2, 2c) rows -> (R, c): rows r and r + R/2 side by side."""
    a = np.array(jnp.asarray(a, jnp.float32))
    return torch.from_numpy(np.concatenate([a[:, :c], a[:, c:]], 0))


def _fold2(a, r, c):
    a = _t(a)
    return a[:r, :c] + a[r:, c:]


def _lanes(v, c):
    v = _t(v)[0]
    return v[:c] + v[c:]


def _bf16_rows(port, jax_vals, name):
    """At most 1% of the entries differ, each by at most one bf16 ulp."""
    a, b = port.float(), jax_vals.float()
    diff = (a - b).abs()
    assert int((diff > 0).sum()) <= 0.01 * a.numel(), name
    assert bool((diff <= 2.0 ** -7 * torch.maximum(a.abs(), b.abs()))
                .all()), name


def _acc(port, jax_vals, name):
    scale = float(jax_vals.abs().max())
    err = float((port - jax_vals).abs().max())
    assert err <= 1e-5 * max(scale, 1e-30), (name, err, scale)


def _setup(rng, negative_scale):
    x = rng.normal(size=(B, C0, S, K)).astype(np.float32)
    layers = list(make_layers(rng, WIDTHS, C0))
    if negative_scale:        # half the layer-3 channels take the min branch
        sc = np.asarray(layers[-1].scale).copy()
        sc[::2] *= -1.0
        layers[-1] = layers[-1]._replace(scale=jnp.asarray(sc))
    return x, tuple(layers)


@pytest.mark.parametrize("negative_scale", [False, True])
def test_bf16_sweep_twins_match_jax_sweeps(rng, monkeypatch,
                                           negative_scale):
    x, layers = _setup(rng, negative_scale)
    store = []
    monkeypatch.setattr(jsp, "pl", _Recorder(store))
    xf = jnp.asarray(x).astype(BF).reshape(B, C0, S * K)
    pooled, stats, p2p, gram2, idxp, gramx = jsp.sa_forward_pair(
        xf, layers, K, EPS, BF, True, True)
    P = B * S
    dp = jnp.asarray(rng.normal(size=(P, C3)).astype(np.float32)).astype(BF)
    jsp.sa_backward_pair(xf, p2p, gram2, idxp, gramx, layers, stats, dp, EPS,
                         BF, True, True)
    assert len(store) == 5            # layer12, gram_pool, sweeps 1-3
    n = B * S * K
    lp1, lp2, lp3 = layers
    (m1, v1), (m2, v2), (m3, v3) = stats
    mul1, shift1 = jax_fold_affine(lp1, m1, v1, EPS)
    mul2, shift2 = jax_fold_affine(lp2, m2, v2, EPS)
    gi2 = lp2.scale * jax.lax.rsqrt(v2 + EPS)
    gi3 = lp3.scale * jax.lax.rsqrt(v3 + EPS)
    (w1, b1, _, _), (w2, b2, _, _), (w3, b3, _, _) = (
        tuple(_t(t) for t in lp) for lp in layers)
    x3 = torch.from_numpy(x).reshape(B, C0, S * K).to(torch.bfloat16)
    bf16 = torch.bfloat16

    # B2a: x -> p2 and its sums.
    p2, s2, ss2 = SP.sa_fwd_layer12_bf16(x3, w1, b1, _t(mul1), _t(shift1),
                                         w2, b2)
    r = store[0]
    assert p2.dtype == bf16
    _bf16_rows(p2, _unpair(r[0], C2), "p2")
    _acc(s2, _lanes(r[1], C2), "sum p2")
    _acc(ss2, _lanes(r[2], C2), "sum p2^2")

    # B2b, on the JAX p2.
    jp2 = _unpair(r[0], C2).to(bf16)
    out = SP.sa_fwd_gram_pool_bf16(jp2, _t(mul2), _t(shift2), w3, b3, K)
    r = store[1]
    _acc(out[0], _fold2(r[0], C2, C2), "G2")
    _acc(out[1], _lanes(r[1], C2), "ch2")
    for i, name in enumerate(("max", "min")):
        assert out[2 + i].dtype == bf16
        _bf16_rows(out[2 + i], _unpair(r[2 + i], C3), name)
    for i, name in enumerate(("argmax", "argmin")):
        assert torch.equal(out[4 + i], _unpair(r[4 + i], C3).to(torch.int32)
                           ), name

    # B3a, on the JAX p2 and pool routing.
    idx = _unpair(idxp, C3).to(torch.int32)
    A3, u3, q3 = SP.sa_bwd_sweep1_bf16(jp2, _t(mul2), _t(shift2),
                                       _t(dp).to(bf16), idx, _t(gi3), w3, K)
    r = store[2]
    jA3, ju3, jq3 = _fold2(r[0], C3, C2), _lanes(r[1], C3), _unpair(r[2], C2)
    _acc(A3, jA3, "A3")
    _acc(u3, ju3, "u3")
    _bf16_rows(q3, jq3, "q3")

    # B3b, on the JAX q3 and layer-3 terms.
    t3 = jax_layer_terms(jnp.asarray(jA3.numpy()), jnp.asarray(ju3.numpy()),
                         lp3, m3, v3, gram2[0], gram2[1], n, EPS)
    A2, G1, u2, ch1, mq = SP.sa_bwd_sweep2_bf16(
        x3, w1, b1, _t(mul1), _t(shift1), jp2, _t(mul2), _t(shift2),
        jq3.to(bf16), _t(t3["M"]), _t(t3["rc"]), _t(gi2), w2)
    r = store[3]
    sums = _t(r[1])[0]
    jA2, jG1 = _fold2(r[0][:2 * C2], C2, C1), _fold2(r[0][2 * C2:], C1, C1)
    ju2 = sums[:C2] + sums[C2:2 * C2]
    jch1 = sums[2 * C2:2 * C2 + C1] + sums[2 * C2 + C1:]
    for a, b_, name in ((A2, jA2, "A2"), (G1, jG1, "G1"), (u2, ju2, "u2"),
                        (ch1, jch1, "ch1")):
        _acc(a, b_, name)
    jmq = _unpair(r[2], C1)
    _bf16_rows(mq, jmq, "mq")

    # B3c, on the JAX mq and layer-2 terms.
    t2 = jax_layer_terms(jnp.asarray(jA2.numpy()), jnp.asarray(ju2.numpy()),
                         lp2, m2, v2, jnp.asarray(jG1.numpy()),
                         jnp.asarray(jch1.numpy()), n, EPS)
    A1, u1 = SP.sa_bwd_sweep3_bf16(x3, w1, b1, _t(mul1), _t(shift1),
                                   jmq.to(bf16), _t(t2["M"]), _t(t2["rc"]))
    r = _t(store[4])
    _acc(A1, r[:C1, :C0] + r[C1:, C0:2 * C0], "A1")
    _acc(u1, r[:C1, 2 * C0] + r[C1:, 2 * C0], "u1")


def _jax_stage(impl, x, dtype):
    stage = JaxStage(WIDTHS, impl=impl, dtype=dtype)
    variables = stage.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)

    def loss(v, x):
        out, mut = stage.apply(v, x, train=True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) ** 2), (mut["batch_stats"],
                                                       out)

    (lo, (bs, out)), g = jax.value_and_grad(loss, has_aux=True)(
        variables, jnp.asarray(x))
    eval_out = stage.apply(variables, jnp.asarray(x), train=False)
    return variables, float(lo), bs, g["params"], out, eval_out


def _port_stage(variables, impl, dtype):
    st = SetAbstractionStage(4, WIDTHS, impl=impl, channels_first=False,
                             dtype=dtype)
    st.load_state_dict(from_jax(variables["params"],
                                variables["batch_stats"]))
    return st


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(a, b, name):
    np.testing.assert_allclose(_f32(a), _f32(b), rtol=5e-2,
                               atol=5e-2, err_msg=name)


def _grad_bars(port, ref, name):
    a = port.double().flatten()
    b = torch.as_tensor(np.asarray(ref, np.float64)).flatten()
    rel = float((a - b).norm() / b.norm())
    cos = float(a @ b / (a.norm() * b.norm()))
    assert rel < 0.15 and cos > 0.99, (name, rel, cos)


@pytest.mark.parametrize("impl", ["pair3", "reference"])
def test_bf16_stage_matches_jax(rng, impl):
    x = rng.normal(size=(2, 4, 8, 4)).astype(np.float32)      # (B, S, K, C)
    variables, jloss, jbs, jg, jout, jeval = _jax_stage(impl, x, BF)
    st = _port_stage(variables, impl, torch.bfloat16).train()
    out = st(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    loss = (out.float() ** 2).sum()
    loss.backward()
    _close(out.detach(), _t(jout), "pooled")
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=5e-2)
    buffers = dict(st.named_buffers())
    for name, jv in jbs.items():
        assert buffers[name].dtype == torch.float32
        _close(buffers[name], np.asarray(jv), name)
    params = dict(st.named_parameters())
    for name, jv in jg.items():
        assert params[name].grad.dtype == torch.float32
        if not name.startswith("bias"):
            _grad_bars(params[name].grad, jv, name)

    # Eval: the bf16 reference with the running statistics (the JAX
    # module's, before the train step updated them).
    ev = _port_stage(variables, impl, torch.bfloat16).eval()
    with torch.no_grad():
        eo = ev(torch.from_numpy(x))
    assert eo.dtype == torch.bfloat16
    _close(eo, _t(jeval), "eval")


def test_bf16_pair3_grads_no_farther_from_f64_than_twice_jax(rng):
    x = rng.normal(size=(2, 4, 8, 4)).astype(np.float32)
    variables, _, _, jg, _, _ = _jax_stage("pair3", x, BF)
    grads = {}
    for label, impl, dtype, cast in (("port", "pair3", torch.bfloat16, None),
                                     ("f64", "reference", torch.float32,
                                      torch.float64)):
        st = _port_stage(variables, impl, dtype).train()
        xt = torch.from_numpy(x)
        if cast is not None:
            st, xt = st.to(cast), xt.to(cast)
        (st(xt).double() ** 2).sum().backward()
        grads[label] = {n: p.grad.double() for n, p in st.named_parameters()}
    names = [n for n in jg if not n.startswith("bias")]

    def dist(g):
        num = sum(float((g[n] - grads["f64"][n]).norm() ** 2) for n in names)
        den = sum(float(grads["f64"][n].norm() ** 2) for n in names)
        return (num / den) ** 0.5
    e_port = dist(grads["port"])
    e_jax = dist({n: torch.as_tensor(np.asarray(jg[n], np.float64))
                  for n in names})
    assert 0 < e_port <= 2 * e_jax, (e_port, e_jax)


@pytest.mark.parametrize("impl", [i for i in IMPLS
                                  if i not in ("pair3", "reference")])
@pytest.mark.parametrize("cpu_input", [True, False])
def test_impls_without_bf16_raise(rng, impl, cpu_input):
    """Train mode at bf16 raises NotImplementedError naming the ROADMAP
    item, before any kernel: on the CPU, and for the card's tensors (a
    meta tensor stands in for them here; the check reads only the
    configuration)."""
    x = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    st = SetAbstractionStage(4, WIDTHS, impl=impl, channels_first=True,
                             dtype=torch.bfloat16).train()
    xt = torch.from_numpy(x)
    if not cpu_input:
        st, xt = st.to("meta"), xt.to("meta")
    with pytest.raises(NotImplementedError, match="Queue 1 item 19"):
        st(xt)


def test_bf16_rows_references_match_jax(rng):
    """ops/fused_sa.py's row references at compute_dtype bfloat16
    (facl_tpu/ops/fused_sa.py:48-95): train (pooled, statistics and the
    gradients of autograd) and eval, at the bars above."""
    from facl_tpu.ops.fused_sa import sa_eval_reference as jax_eval
    from facl_tpu.ops.fused_sa import sa_train_reference as jax_train
    from facl_tpu_torch.ops.fused_sa import SALayerParams, \
        sa_eval_reference, sa_train_reference
    x, layers = _setup(rng, negative_scale=True)
    rows = x.transpose(0, 2, 3, 1).reshape(-1, C0)
    wvec = rng.normal(size=(C3,)).astype(np.float32)

    def jloss(layers):
        pooled, stats = jax_train(jnp.asarray(rows), layers, K, EPS, BF)
        return jnp.sum(jnp.sin(pooled.astype(jnp.float32)) * wvec), \
            (pooled, stats)
    (_, (jp, jstats)), jg = jax.value_and_grad(jloss, has_aux=True)(layers)
    tl = [SALayerParams(*(torch.tensor(np.asarray(t), requires_grad=True)
                          for t in lp)) for lp in layers]
    tp, tstats = sa_train_reference(torch.from_numpy(rows), tl, K, EPS,
                                    torch.bfloat16)
    assert tp.dtype == torch.bfloat16
    (torch.sin(tp.float()) * torch.from_numpy(wvec)).sum().backward()
    _close(tp, jp, "pooled")
    for (tm, tv), (jm, jv) in zip(tstats, jstats):
        assert tm.dtype == tv.dtype == torch.float32
        _close(tm, jm, "mean")
        _close(tv, jv, "var")
    for lt, lj in zip(tl, jg):
        for name in ("kernel", "scale", "shift"):
            _grad_bars(getattr(lt, name).grad, getattr(lj, name), name)

    running = [(rng.normal(size=(w,)).astype(np.float32),
                rng.uniform(0.5, 2.0, size=(w,)).astype(np.float32))
               for w in WIDTHS]
    je = jax_eval(jnp.asarray(rows), layers,
                  [tuple(map(jnp.asarray, r)) for r in running], K, EPS, BF)
    with torch.no_grad():
        te = sa_eval_reference(torch.from_numpy(rows),
                               [SALayerParams(*(_t(t) for t in lp))
                                for lp in layers],
                               [tuple(map(torch.from_numpy, r))
                                for r in running], K, EPS, torch.bfloat16)
    assert te.dtype == torch.bfloat16
    _close(te, je, "eval")
