"""The port's bf16 SA paths (``compute_dtype="bfloat16"``) against the JAX
package at bf16: the five bf16 sweep twins of pair3 (kernels B2a, B2b,
B3a, B3b, B3c on the card) against the outputs of the JAX sweeps they
port, run in interpret mode on the same inputs, and so the six bf16
twins of B6 (pair's sweep 2), B7 (hybrid2's forward sweeps) and B8
(hybrid's and hybrid2's backward sweeps); the pair3, pair, hybrid2, hybrid
and reference stages, train and eval, against the JAX stage at bf16; and
the row references of ops/fused_sa.py at bf16. B9 at bf16 and the
pallas, covar and analytic stages: tests/test_torch_bf16_fused.py.

Tolerances:
  * sweep twins vs the JAX sweeps, fed the JAX side's own inputs: the
    bf16 row outputs (p1, p2, max, min, pooled, q3, mq) differ on at most
    1% of their entries and there by at most one bf16 ulp (2^-7 of the
    value); pool indices equal; f32 accumulators within 1e-5 of their max-abs (only
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
from facl_tpu_torch.models.sa_stage import SetAbstractionStage
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


def _rec_two_sweep(monkeypatch, store):
    """Record the pallas_calls of the JAX package's B7 and B8 modules."""
    import facl_tpu.ops.pallas.sa_bwd as jsb
    import facl_tpu.ops.pallas.sa_fwd as jsf
    monkeypatch.setattr(jsf, "pl", _Recorder(store))
    monkeypatch.setattr(jsb, "pl", _Recorder(store))
    return jsf, jsb


@pytest.mark.parametrize("negative_scale", [False, True])
def test_bf16_two_sweep_twins_match_jax_sweeps(rng, monkeypatch,
                                               negative_scale):
    """The bf16 twins of B7 (x -> p1, p1 -> p2, Gram, pool) and B8 (sweeps
    1 and 2) against hybrid2's JAX sweeps at bf16 in interpret mode, each
    fed the JAX side's own inputs."""
    from facl_tpu_torch.ops import sa_bwd as SB
    from facl_tpu_torch.ops import sa_fwd as SF
    x, layers = _setup(rng, negative_scale)
    rows = x.transpose(0, 2, 3, 1).reshape(-1, C0)
    store = []
    jsf, jsb = _rec_two_sweep(monkeypatch, store)
    xf = jnp.asarray(rows).astype(BF)
    _, stats, jp1, jp2 = jsf.sa_forward_pallas(xf, layers, K, EPS, BF, True)
    P = B * S
    dp = jnp.asarray(rng.normal(size=(P, C3)).astype(np.float32)).astype(BF)
    jsb.sa_backward_pallas(xf, jp1, jp2, layers, stats, dp, EPS, BF, True)
    assert len(store) == 6            # layer x2, gram, pool, sweeps 1-2
    n = B * S * K
    lp1, lp2, lp3 = layers
    (m1, v1), (m2, v2), (m3, v3) = stats
    mul1, shift1 = (_t(a) for a in jax_fold_affine(lp1, m1, v1, EPS))
    mul2, shift2 = (_t(a) for a in jax_fold_affine(lp2, m2, v2, EPS))
    mul3, shift3 = (_t(a) for a in jax_fold_affine(lp3, m3, v3, EPS))
    gi2 = _t(lp2.scale * jax.lax.rsqrt(v2 + EPS))
    gi3 = _t(lp3.scale * jax.lax.rsqrt(v3 + EPS))
    (w1, b1, _, _), (w2, b2, _, _), (w3, b3, _, _) = (
        tuple(_t(t) for t in lp) for lp in layers)
    bf16 = torch.bfloat16
    xb = torch.from_numpy(rows).to(bf16)

    # B7a twice: x -> p1, then the JAX p1 -> p2.
    p1b, p2b = (_t(store[i][0]).to(bf16) for i in (0, 1))
    for i, args in enumerate(((xb, w1, b1), (p1b, w2, b2, mul1, shift1))):
        p, s, ss = SF.sa_fwd_layer_bf16(*args)
        assert p.dtype == bf16
        _bf16_rows(p, _t(store[i][0]), f"p{i + 1}")
        _acc(s, _t(store[i][1])[0], f"sum p{i + 1}")
        _acc(ss, _t(store[i][2])[0], f"sum p{i + 1}^2")
    # B7b and B7c on the JAX p2.
    G2, ch2 = SF.sa_fwd_gram_bf16(p2b, mul2, shift2)
    _acc(G2, _t(store[2][0]), "G2")
    _acc(ch2, _t(store[2][1])[0], "ch2")
    pooled = SF.sa_fwd_pool_bf16(p2b, mul2, shift2, w3, b3, mul3, shift3, K)
    assert pooled.dtype == bf16
    _bf16_rows(pooled, _t(store[3]), "pooled")

    # B8a: the packed [dy3 | h2]^T [h2 | ones] and q3.
    A3, u3, G2b, ch2b, q3 = SB.sa_bwd2_sweep1_bf16(
        p2b, mul2, shift2, w3, b3, mul3, shift3, gi3, _t(dp).to(bf16), K)
    out1, jq3 = _t(store[4][0]), _t(store[4][1])
    for a, b_, name in ((A3, out1[:C3, :C2], "A3"), (u3, out1[:C3, C2], "u3"),
                        (G2b, out1[C3:, :C2], "G2"),
                        (ch2b, out1[C3:, C2], "ch2")):
        _acc(a, b_, name)
    _bf16_rows(q3, jq3, "q3")

    # B8b on the JAX q3 and layer-3 terms: the packed [dy2 | m1 | m1*q2 |
    # m1*x_i .. | x | h1]^T [h1 | x | ones].
    t3 = jax_layer_terms(jnp.asarray(out1[:C3, :C2].numpy()),
                         jnp.asarray(out1[:C3, C2].numpy()), lp3, m3, v3,
                         jnp.asarray(out1[C3:, :C2].numpy()),
                         jnp.asarray(out1[C3:, C2].numpy()), n, EPS)
    m = SB.sa_bwd2_sweep2_bf16(xb, p1b, mul1, shift1, p2b, mul2, shift2,
                               jq3.to(bf16), _t(t3["M"]), _t(t3["rc"]), gi2,
                               w2)
    o = _t(store[5][0])
    h, xc, one = slice(0, C1), slice(C1, C1 + C0), C1 + C0
    want = dict(A2=o[:C2, h], u2=o[:C2, one], TM1=o[C2:C2 + C1, h],
                T1x=o[C2:C2 + C1, xc], cnt1=o[C2:C2 + C1, one],
                P1=o[C2 + C1:C2 + 2 * C1, xc],
                acc1=o[C2 + C1:C2 + 2 * C1, one])
    r = C2 + 2 * C1
    want["U1"] = torch.stack([o[r + i * C1:r + (i + 1) * C1, h]
                              for i in range(C0)], -1)
    r += C0 * C1
    want.update(Gx=o[r:r + C0, xc], cx=o[r:r + C0, one],
                G1=o[r + C0:r + C0 + C1, h], ch1=o[r + C0:r + C0 + C1, one])
    assert set(m) == set(want)
    for name, w in want.items():
        _acc(m[name], w, name)


@pytest.mark.parametrize("negative_scale", [False, True])
def test_bf16_b6_twin_matches_jax_sweep(rng, monkeypatch, negative_scale):
    """The bf16 twin of B6 (pair's non-slim sweep 2, h1 from x) against the
    JAX pair sweep at bf16 in interpret mode (facl_tpu/ops/pallas/
    sa_pair.py:333-400), fed the JAX side's p2, q3 and layer-3 terms: its
    paired main [dy2 | m1 | m1*x_i .. | h1]^T h1 and aux [dy2 | m1 | m1*q2
    | x | h1]^T [x | ones] products, folded."""
    x, layers = _setup(rng, negative_scale)
    store = []
    monkeypatch.setattr(jsp, "pl", _Recorder(store))
    xf = jnp.asarray(x).astype(BF).reshape(B, C0, S * K)
    pooled, stats, p2p, gram2, idxp, gramx = jsp.sa_forward_pair(
        xf, layers, K, EPS, BF, True, True)
    dp = jnp.asarray(rng.normal(size=(B * S, C3)).astype(np.float32)
                     ).astype(BF)
    jsp.sa_backward_pair(xf, p2p, gram2, idxp, gramx, layers, stats, dp, EPS,
                         BF, True, False)
    assert len(store) == 4            # layer12, gram_pool, sweep 1, B6
    n = B * S * K
    lp1, lp2, lp3 = layers
    (m1, v1), (m2, v2), (m3, v3) = stats
    mul1, shift1 = jax_fold_affine(lp1, m1, v1, EPS)
    mul2, shift2 = jax_fold_affine(lp2, m2, v2, EPS)
    gi2 = lp2.scale * jax.lax.rsqrt(v2 + EPS)
    (w1, b1, _, _), (w2, _, _, _), _ = (tuple(_t(t) for t in lp)
                                        for lp in layers)
    bf16 = torch.bfloat16
    x3 = torch.from_numpy(x).reshape(B, C0, S * K).to(bf16)
    r = store[2]
    jA3, ju3, jq3 = _fold2(r[0], C3, C2), _lanes(r[1], C3), _unpair(r[2], C2)
    t3 = jax_layer_terms(jnp.asarray(jA3.numpy()), jnp.asarray(ju3.numpy()),
                         lp3, m3, v3, gram2[0], gram2[1], n, EPS)
    m = SP.sa_bwd_sweep2_full_bf16(
        x3, w1, b1, _t(mul1), _t(shift1), _unpair(store[0][0], C2).to(bf16),
        _t(mul2), _t(shift2), jq3.to(bf16), _t(t3["M"]), _t(t3["rc"]),
        _t(gi2), w2)
    om, oa = _t(store[3][0]), _t(store[3][1])

    def fm(i, a, b_):       # the i-th (2a, 2C1) block of main, folded
        return om[i:i + 2 * a, :2 * b_][:a, :b_] + \
            om[i:i + 2 * a, :2 * b_][a:, b_:]

    def fa(i, a):           # aux rows i .. i + 2a: x block folded, ones
        blk = oa[i:i + 2 * a]
        return (blk[:a, :C0] + blk[a:, C0:2 * C0],
                blk[:a, 2 * C0] + blk[a:, 2 * C0])
    want = dict(A2=fm(0, C2, C1), TM1=fm(2 * C2, C1, C1),
                U1=torch.stack([fm(2 * C2 + 2 * C1 * (1 + i), C1, C1)
                                for i in range(C0)], -1),
                G1=fm(2 * C2 + 2 * C1 * (1 + C0), C1, C1))
    want["u2"] = fa(0, C2)[1]
    want["T1x"], want["cnt1"] = fa(2 * C2, C1)
    want["P1"], want["acc1"] = fa(2 * C2 + 2 * C1, C1)
    want["Gx"], want["cx"] = fa(2 * C2 + 4 * C1, C0)
    want["ch1"] = fa(2 * C2 + 4 * C1 + 2 * C0, C1)[1]
    assert set(m) == set(want)
    for name, w in want.items():
        _acc(m[name], w, name)


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


def stage_vs_jax(rng, impl, jax_impl=None):
    """The port's stage with ``impl`` at bf16 against JAX's with
    ``jax_impl`` (default: the same impl) at bf16: pooled (bf16), loss,
    running statistics and parameter gradients after one train step; and
    eval, the bf16 reference with the running statistics (the JAX
    module's, before the train step updated them)."""
    x = rng.normal(size=(2, 4, 8, 4)).astype(np.float32)      # (B, S, K, C)
    variables, jloss, jbs, jg, jout, jeval = _jax_stage(jax_impl or impl, x,
                                                        BF)
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

    ev = _port_stage(variables, impl, torch.bfloat16).eval()
    with torch.no_grad():
        eo = ev(torch.from_numpy(x))
    assert eo.dtype == torch.bfloat16
    _close(eo, _t(jeval), "eval")


@pytest.mark.parametrize("impl", ["pair3", "pair", "hybrid2", "hybrid",
                                  "reference"])
def test_bf16_stage_matches_jax(rng, impl):
    stage_vs_jax(rng, impl)


def grads_vs_f64(rng, impl):
    """The port's bf16 stage gradients of ``impl`` against float64 (the
    port's reference stage in float64), beside JAX's same impl at bf16:
    no farther than twice JAX's (relative L2 over the gradients but the
    Dense biases, together)."""
    x = rng.normal(size=(2, 4, 8, 4)).astype(np.float32)
    variables, _, _, jg, _, _ = _jax_stage(impl, x, BF)
    grads = {}
    for label, run, dtype, cast in (("port", impl, torch.bfloat16, None),
                                    ("f64", "reference", torch.float32,
                                     torch.float64)):
        st = _port_stage(variables, run, dtype).train()
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


@pytest.mark.parametrize("impl", ["pair3", "pair", "hybrid2", "hybrid"])
def test_bf16_pair3_grads_no_farther_from_f64_than_twice_jax(rng, impl):
    """The bf16 stage of each impl with bf16 kernels (pair3 first, whence
    the name) against float64, beside the JAX package's same impl."""
    grads_vs_f64(rng, impl)


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
