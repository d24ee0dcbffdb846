"""The port's last bf16 SA paths against the JAX package at bf16: kernel
B9's four bf16 sweep twins (``sa_impl="pallas"``, ops/sa_kernel.py)
against the outputs of the JAX kernel they port
(facl_tpu/ops/pallas/sa_kernel.py, multi-call form, interpret mode) fed
the JAX side's own inputs; ``sa_train_fused`` at bf16 against JAX's;
``covar_moments`` on bf16 rows; analytic's per-layer backward against
JAX's ``_layer_bwd`` under jit; the pallas, covar and analytic stages
and the bf16 Trainer step against JAX's; and the shipped bf16 configs
stepping at full width with each of the three impls, and the pretrain
CLI at bf16 with each.

Tolerances:
  * B9 twins vs the JAX sweeps: the f32 accumulators (stats sums, BN
    sums, dW) and dx within 1e-5 of their max-abs (kernel and twin sum
    the same exact bf16 products in f32, in other orders); db, exactly
    zero in exact arithmetic (a BatchNorm follows each Dense), within
    1e-5 of the layer's dW max-abs; the pooled values differ on at most
    1% of their entries, by at most one bf16 ulp (tests/
    test_torch_bf16_sa.py's sweep bars);
  * covar_moments and analytic's layer backward within 1e-5 of their
    max-abs (the same f32 sums of bf16 values, in other orders);
  * stages and sa_train_fused: outputs, loss and BatchNorm statistics at
    rtol = atol = 5e-2 (tests/test_covar_bn.py:38-39), gradients at
    relative L2 < 0.15 and cosine > 0.99 (tests/test_sa_pair.py:109-135),
    the Dense biases (zero under BatchNorm) skipped; and the port's bf16
    gradients no farther from float64 than twice JAX's;
  * the Trainer step at tests/test_torch_bf16_step.py's bars.

JAX's pallas stage compiles its kernel for a TPU (no interpret mode,
facl_tpu/models/sa_stage.py:135-139), so the port's pallas stage and
step are held against JAX's reference stage and step at bf16, and its
sa_train_fused against JAX's sa_train_fused in interpret mode on the
same rows. Weights reach the port through ``convert.from_jax``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facl_tpu.ops.pallas.sa_kernel as jsk
from facl_tpu.models.sa_stage import covar_moments as jax_covar_moments
from facl_tpu.ops.analytic_sa import _layer_bwd as jax_layer_bwd
from facl_tpu.ops.fused_sa import SALayerParams as JaxLayer
from facl_tpu.ops.fused_sa import sa_train_fused as jax_sa_train_fused
from facl_tpu_torch.models.sa_stage import covar_moments
from facl_tpu_torch.ops import sa_kernel as SK
from facl_tpu_torch.ops.analytic_sa import _layer_bwd
from facl_tpu_torch.ops.fused_sa import SALayerParams, sa_train_fused, \
    sa_train_reference
from tests.test_analytic_sa import make_layers
from tests.test_torch_bf16_sa import BF, _bf16_rows, _close, _grad_bars, \
    _jax_stage, _port_stage, _Recorder, _t, grads_vs_f64, stage_vs_jax
from tests.test_torch_bf16_step import shipped_step, step_vs_jax
from tests.test_torch_cli import cli_root, tiny_cfg_file  # noqa: F401

EPS = 1e-5
BF16 = torch.bfloat16


def _acc(port, ref, name, scale=None):
    ref = torch.from_numpy(np.array(ref, np.float32))
    scale = float(ref.abs().max()) if scale is None else scale
    err = float((port - ref).abs().max())
    assert err <= 1e-5 * max(scale, 1e-30), (name, err, scale)


def _rows(rng, R, K, ties):
    x = rng.normal(size=(R, 4)).astype(np.float32)
    if ties:                  # duplicated rows tie every group's max
        x[1::2] = x[::2]
    return x


def _layers(rng, widths):
    """The same weights for both packages (tests/test_fused_sa.py)."""
    out, cin = [], 4
    for w in widths:
        out.append([rng.normal(size=(cin, w)).astype(np.float32) * 0.5,
                    rng.normal(size=(w,)).astype(np.float32) * 0.1,
                    1.0 + 0.1 * rng.normal(size=(w,)).astype(np.float32),
                    0.1 * rng.normal(size=(w,)).astype(np.float32)])
        cin = w
    jl = tuple(JaxLayer(*(jnp.asarray(a) for a in lp)) for lp in out)
    tl = [SALayerParams(*(torch.from_numpy(a).requires_grad_(True)
                          for a in lp)) for lp in out]
    return jl, tl


@pytest.mark.parametrize("widths,ties", [((8, 16, 32), False),
                                         ((8, 16, 32), True),
                                         ((16, 32), False)])
def test_bf16_b9_twins_match_jax_sweeps(rng, monkeypatch, widths, ties):
    """Each of B9's bf16 sweep twins against the JAX kernel's sweep at
    bf16, fed the JAX side's statistics, BN sums and cotangent: L stats
    sweeps, the pool sweep, L BN-sum sweeps top-down, the final sweep."""
    R, K, L = 256, 8, len(widths)
    x = _rows(rng, R, K, ties)
    jl, tl = _layers(rng, widths)
    store = []
    monkeypatch.setattr(jsk, "pl", _Recorder(store))
    _, _, packed = jsk.sa_train_forward_pallas(jnp.asarray(x), jl, K, EPS,
                                               BF, True)
    dout = jnp.asarray(rng.normal(size=(R // K, widths[-1])).astype(
        np.float32)).astype(BF).astype(jnp.float32)
    jsk.sa_train_backward_pallas(jnp.asarray(x), jl, packed, dout, K, EPS,
                                 BF, True, True)
    assert len(store) == 2 * L + 2
    xt, packed, dout = torch.from_numpy(x), _t(packed), _t(dout)
    layers = [SALayerParams(*(t.detach() for t in lp)) for lp in tl]
    for l in range(L):
        s, ss = SK.sa_fused_stats_bf16(xt, layers, packed, K, l)
        _acc(s, store[l][0], f"sum p{l}")
        _acc(ss, store[l][1], f"sum p{l}^2")
    pooled = SK.sa_fused_pool_bf16(xt, layers, packed, K)
    assert pooled.dtype == torch.float32
    assert torch.equal(pooled, pooled.to(BF16).float())
    _bf16_rows(pooled, _t(store[L]), "pooled")
    bsums = torch.zeros_like(packed)
    for j, l in enumerate(reversed(range(L))):
        s_dy, s_dyx = SK.sa_fused_bnsum_bf16(xt, layers, packed, bsums,
                                             dout, K, l)
        r = _t(store[L + 1 + j])
        _acc(s_dy, r[0], f"sum dy{l}")
        _acc(s_dyx, r[1], f"sum dy xhat{l}")
        bsums[l, 0, :widths[l]], bsums[l, 1, :widths[l]] = r[0], r[1]
    dx, dws, dbs = SK.sa_fused_final_bf16(xt, layers, packed, bsums, dout,
                                          K)
    r = [_t(a) for a in store[-1]]
    _acc(dx, r[0], "dx")
    for l in range(L):
        _acc(dws[l], r[1 + l], f"dW{l}")
        _acc(dbs[l], r[1 + L + l][0], f"db{l}",
             scale=float(r[1 + l].abs().max()))


def _fused_both(rng, ties):
    R, K = 128, 8
    x = _rows(rng, R, K, ties)
    jl, tl = _layers(rng, (8, 16))
    wvec = rng.normal(size=(16,)).astype(np.float32)

    def jloss(x, layers):
        pooled, _ = jax_sa_train_fused(x, layers, K, EPS, BF, True)
        return jnp.sum(jnp.sin(pooled.astype(BF).astype(jnp.float32))
                       * wvec), pooled

    (jv, jp), (jgx, jgl) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jl)
    xt = torch.from_numpy(x).requires_grad_(True)
    pooled, _ = sa_train_fused(xt, tl, K, EPS, compute_dtype=BF16)
    tv = (torch.sin(pooled.to(BF16).float()) * torch.from_numpy(wvec)).sum()
    tv.backward()
    jg = {"x": jgx}
    tg = {"x": xt.grad}
    for i, (lj, lt) in enumerate(zip(jgl, tl)):
        for n in ("kernel", "scale", "shift"):
            jg[f"{n}{i}"], tg[f"{n}{i}"] = getattr(lj, n), \
                getattr(lt, n).grad
    return dict(x=x, jl=jl, tl=tl, K=K, wvec=wvec, jv=float(jv), jp=jp,
                tv=float(tv.detach()), tp=pooled.detach(), jg=jg, tg=tg)


@pytest.mark.parametrize("ties", [False, True])
def test_bf16_sa_train_fused_matches_jax(rng, ties):
    """sa_train_fused at bf16 (B9's bf16 twins behind the autograd
    function) against JAX's sa_train_fused at bf16 in interpret mode: the
    loss through the stage's bf16 cast of the pooled rows, the pooled
    rows, and the gradients of x and every parameter; with ``ties`` the
    duplicated-row case of tests/test_torch_sa_kernel.py."""
    r = _fused_both(rng, ties)
    assert r["tp"].dtype == torch.float32
    _close(r["tp"], r["jp"], "pooled")
    np.testing.assert_allclose(r["tv"], r["jv"], rtol=5e-2)
    assert r["tg"]["x"].dtype == torch.float32
    for name, jv in r["jg"].items():
        _grad_bars(r["tg"][name], jv, name)


@pytest.mark.parametrize("ties", [False, True])
def test_bf16_fused_grads_no_farther_from_f64_than_twice_jax(rng, ties):
    """The port's bf16 sa_train_fused gradients against float64 (autograd
    of the plain reference), beside JAX's bf16 gradients."""
    r = _fused_both(rng, ties)
    x = torch.from_numpy(r["x"]).double().requires_grad_(True)
    l64 = [SALayerParams(*(t.detach().double().requires_grad_(True)
                           for t in lp)) for lp in r["tl"]]
    p64, _ = sa_train_reference(x, l64, r["K"], EPS)
    (torch.sin(p64) * torch.from_numpy(r["wvec"]).double()).sum().backward()
    f64 = {"x": x.grad}
    for i, lp in enumerate(l64):
        for n in ("kernel", "scale", "shift"):
            f64[f"{n}{i}"] = getattr(lp, n).grad

    def dist(g):
        num = sum(float((torch.as_tensor(np.asarray(g[n], np.float64))
                         - f64[n]).norm() ** 2) for n in f64)
        den = sum(float(f64[n].norm() ** 2) for n in f64)
        return (num / den) ** 0.5
    e_port = dist({n: t.double() for n, t in r["tg"].items()})
    e_jax = dist(r["jg"])
    assert 0 < e_port <= 2 * e_jax, (e_port, e_jax)


@pytest.mark.parametrize("n,cin,cout", [(512, 16, 32), (2048, 64, 256)])
def test_covar_moments_on_bf16_rows_match_jax(rng, n, cin, cout):
    """covar_moments on a bf16 h: an f32 Gram of its values, f32 column
    sums, the finalise with the f32 kernel and bias
    (facl_tpu/models/sa_stage.py:33-68 at precision None, as the bf16
    stage calls it)."""
    h = np.maximum(rng.normal(size=(n // 8, 8, cin)), 0).astype(np.float32)
    w = (rng.normal(size=(cin, cout)) / cin ** 0.5).astype(np.float32)
    b = rng.normal(size=(cout,), scale=0.2).astype(np.float32)
    jm, jv = jax_covar_moments(jnp.asarray(h).astype(BF), jnp.asarray(w),
                               jnp.asarray(b))
    m, v = covar_moments(torch.from_numpy(h).to(BF16), torch.from_numpy(w),
                         torch.from_numpy(b))
    assert m.dtype == v.dtype == torch.float32
    _acc(m, jm, "mean")
    _acc(v, jv, "var")


@pytest.mark.parametrize("cin,cout", [(8, 16), (16, 32)])
def test_bf16_analytic_layer_bwd_matches_jax(rng, cin, cout):
    """analytic's backward through one layer at bf16, fed JAX's own dy,
    h_prev and statistics, against facl_tpu/ops/analytic_sa.py::_layer_bwd
    as XLA compiles it (jax.jit), within 1e-5 of each output's max-abs."""
    lp = make_layers(rng, (cout,), cin)[0]
    h = jnp.asarray(np.maximum(rng.normal(size=(4, 16, 8, cin)), 0)
                    .astype(np.float32)).astype(BF)
    dy = jnp.asarray(rng.normal(size=(4, 16, 8, cout)).astype(np.float32)
                     ).astype(BF)
    mean = jnp.asarray(rng.normal(size=(cout,)).astype(np.float32))
    var = jnp.asarray(rng.uniform(0.5, 2.0, size=(cout,)).astype(np.float32))
    want = jax.jit(lambda *a: jax_layer_bwd(*a, EPS, BF))(dy, h, lp, mean,
                                                          var)
    got = _layer_bwd(_t(dy).reshape(-1, cout), _t(h).reshape(-1, cin),
                     SALayerParams(*(_t(a) for a in lp)), _t(mean), _t(var),
                     EPS, BF16)
    for name, a, b in zip(("dW", "db", "dgamma", "dbeta", "dh_prev"), got,
                          want):
        b = np.asarray(b, np.float32)
        if name == "db":        # zero in exact arithmetic: dW's scale
            _acc(a, b, name, scale=float(np.abs(np.asarray(want[0])).max()))
        else:
            _acc(a, b.reshape(a.shape), name)


@pytest.mark.parametrize("impl,jax_impl", [("covar", "covar"),
                                           ("analytic", "analytic"),
                                           ("pallas", "reference")])
def test_bf16_stage_matches_jax(rng, impl, jax_impl):
    """The port's stage at bf16 against JAX's stage at bf16 (the pallas
    stage against JAX's reference stage, whose semantics define B9), as
    tests/test_torch_bf16_sa.py holds the other impls."""
    stage_vs_jax(rng, impl, jax_impl)


@pytest.mark.parametrize("impl", ["covar", "analytic"])
def test_bf16_stage_grads_no_farther_from_f64_than_twice_jax(rng, impl):
    """covar's and analytic's bf16 stage gradients against float64, beside
    JAX's same impl at bf16."""
    grads_vs_f64(rng, impl)


def test_pallas_bf16_input_grad_matches_analytic(rng):
    """With ``input_grad`` the bf16 pallas stage returns B9's f32 dx (the
    final sweep's dp0 W0^T) through the channel-major input: held against
    the bf16 analytic stage's input gradient on the same weights, at the
    gradient bars."""
    x = rng.normal(size=(2, 4, 8, 4)).astype(np.float32)
    variables = _jax_stage("reference", x, BF)[0]
    grads = {}
    for impl in ("pallas", "analytic"):
        st = _port_stage(variables, impl, BF16).train()
        st.input_grad = True
        xt = torch.from_numpy(x).requires_grad_(True)
        (st(xt).float() ** 2).sum().backward()
        assert xt.grad.dtype == torch.float32
        grads[impl] = xt.grad
    _grad_bars(grads["pallas"], grads["analytic"].numpy(), "dx")


@pytest.mark.parametrize("sa_impl", ["pallas", "covar", "analytic"])
def test_bf16_step_matches_jax_trainer(rng, sa_impl):
    """One bf16 step of the port's Trainer with pallas (B9's bf16 twins;
    against JAX's reference step, whose stage JAX's pallas kernel
    computes on a TPU), covar and analytic against JAX's Trainer."""
    step_vs_jax(rng, sa_impl, "reference" if sa_impl == "pallas" else None)


@pytest.mark.parametrize("sa_impl", ["pallas", "covar", "analytic"])
@pytest.mark.parametrize("name", ["motion_ntu60_xview.json",
                                  "appearance_ntu60_xsub.json"])
def test_shipped_bf16_config_steps_at_full_width(rng, name, sa_impl):
    """The shipped bf16 configs with sa_impl forced to pallas, covar or
    analytic: the port's Trainer builds and takes one full-width step on
    the CPU at batch 2."""
    shipped_step(rng, name, sa_impl)


@pytest.mark.parametrize("sa_impl", ["pallas", "covar", "analytic"])
def test_pretrain_cli_bf16_with_each_impl(cli_root, tiny_cfg_file,  # noqa: F811
                                          tmp_path, sa_impl):
    """``python -m facl_tpu_torch.cli.pretrain --dtype bfloat16 --sa-impl
    pallas|covar|analytic`` runs an epoch (on the JAX generator's tiny
    tree and tests/test_torch_cli.py's tiny config, on the CPU): a finite
    loss and a checkpoint."""
    from facl_tpu_torch.cli import pretrain
    root, _ = cli_root
    ck = str(tmp_path / "ck")
    hist = pretrain.main(["--root", root, "--stream", "motion",
                          "--batch-size", "2", "--dtype", "bfloat16",
                          "--sa-impl", sa_impl, "--config", tiny_cfg_file,
                          "--device", "cpu", "--epochs", "1", "--out", ck])
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
    assert os.path.exists(os.path.join(ck, "ckpt_epoch_00000.pt"))
