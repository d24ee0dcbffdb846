"""The arithmetic of B9's f32 kernel on the TF32 tensor cores
(csrc/sa_fused.cu, sa_fused_tf32_kernel), emulated in torch where the CPU
can check it.

The kernel runs three products as mma.sync m16n8k8 TF32 in the 3xTF32
split (each f32 operand a = hi + lo, hi = tf32(a), lo = tf32(a - hi);
each k8 step lo.hi' + hi.lo' + hi.hi' is summed on its own, then added to
the f32 accumulator, round to nearest: step3): the forward p_l = h_{l-1}
W_l + b_l of layers 1 and 2, da_{l-1} = dp_l W_l^T, and dW_l = h_{l-1}^T
dp_l, whose 64-row tiles are each summed on their own in f32, added into
f32 registers and carried into float64 every 32 tiles. ``mm_b9``
emulates that order (a k8 step's 24 exact products summed in float64 and
rounded to f32 once; the tensor cores' own adds inside a step truncate
and are not documented, so this is a model of them, not a bit-exact
copy).

The operands are the JAX package's f32 B9 chain on the CPU, at the main
path's magnitudes (grouped rows re-centred in a ball of r^2 = 0.06,
weights at flax's Dense init): facl_tpu/ops/pallas/sa_kernel.py's
forward and backward in interpret mode give the statistics and BN sums,
its _prefix, _pool_grad and _backprop_to the activations h and the dp of
every layer. Each product is held against float64 at chip_smoke.py's
phase 2 f32 bars: p and da at rtol 1e-5 / atol 1e-5 x scale, dW within
1e-4 of its max-abs; single-pass TF32 misses them.

Beside the bars: layer 1's ReLU mask is a decision, and the twin (and
the CUDA-core kernel) sums h W in k order with fmaf from 0. The kernel
sums again in that order every p whose y lies within the window
``near_zero`` (sa_fused.cu) of 0; here the window covers the distance
between the emulated tensor-core y and the k-order y on every sum, so
after that redo no mask differs from the k-order chain's (without it
they may: chip_ablate.py b9_f32 counts the dx rows that move). The
emulation rounds each k8 step once; the tensor cores' adds within a step
truncate, so the margin on the card is chip_ablate.py tc_sums_tf's to
measure, not this test's. The top
layer's pool routing is not redone: its argmax changes only where two
values of a group lie within chip_smoke's near-tie tolerance (1e-5 of
the largest |z|). The emulation lives here only; nothing on the port's
path uses it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facl_tpu.ops.pallas.sa_kernel as jsk
from facl_tpu.ops.fused_sa import SALayerParams as JaxLayer
from tests.test_torch_tf32x3 import mm_1x, tf32

K, G, C0, WIDTHS = 64, 64, 4, (64, 64, 256)
R = K * G
TILE, FLUSH = 64, 32          # rows a dW tile sums; tiles between carries
EPS = 1e-5


def mm_b9(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, kdim) @ b (kdim, N) as the kernel's step3 sums it: per k8
    step lo.hi' + hi.lo' + hi.hi' (exact products of TF32 pieces, summed
    in float64, rounded to f32), added to the f32 accumulator."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    c = torch.zeros(a.shape[0], b.shape[1])
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        st = sum(x[:, s].double() @ y[s].double()
                 for x, y in ((al, bh), (ah, bl), (ah, bh)))
        c = c + st.float()
    return c


def dw_b9(h: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
    """h^T dp over the rows as the final sweep sums it: each 64-row tile's
    part by mm_b9, added to the f32 registers, carried into float64 every
    FLUSH tiles and at the end."""
    out = torch.zeros(h.shape[1], dp.shape[1], dtype=torch.float64)
    reg = torch.zeros(h.shape[1], dp.shape[1])
    n = h.shape[0] // TILE
    for t in range(n):
        rows = slice(t * TILE, (t + 1) * TILE)
        reg = reg + mm_b9(h[rows].T.contiguous(), dp[rows])
        if (t + 1) % FLUSH == 0 or t + 1 == n:
            out += reg.double()
            reg = torch.zeros_like(reg)
    return out


def mm_chain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in k order, fmaf from 0 (the exact product plus the running
    sum, rounded once to f32; float64 holds both exactly but for a rare
    double rounding)."""
    s = torch.zeros(a.shape[0], b.shape[1])
    for k in range(a.shape[1]):
        s = (a[:, k:k + 1].double() * b[k:k + 1].double()
             + s.double()).float()
    return s


@pytest.fixture(scope="module")
def chain():
    """The JAX package's f32 B9 chain on numpy-seeded inputs: the weights,
    the activations h_0 = x, h_1, h_2 (inputs of layers 0-2), the dp of
    every layer, the statistics and the folded affines (ay, by) of
    layers 1 and 2."""
    rng = np.random.default_rng(7)
    xyz = rng.uniform(-0.14, 0.14, size=(R, 3))
    x = np.concatenate([xyz, rng.normal(size=(R, 1))], 1).astype(np.float32)
    layers, cin = [], C0
    for w in WIDTHS:
        layers.append(JaxLayer(
            jnp.asarray(rng.normal(size=(cin, w)) / np.sqrt(cin),
                        jnp.float32),
            jnp.asarray(0.1 * rng.normal(size=w), jnp.float32),
            jnp.asarray(1 + 0.1 * rng.normal(size=w), jnp.float32),
            jnp.asarray(0.1 * rng.normal(size=w), jnp.float32)))
        cin = w
    xj = jnp.asarray(x)
    _, _, packed = jsk.sa_train_forward_unified(xj, tuple(layers), K,
                                                interpret=True)
    dout = jnp.asarray(1e-3 * rng.normal(size=(G, WIDTHS[-1])), jnp.float32)
    _, grads = jsk.sa_train_backward_unified(xj, tuple(layers), packed, dout,
                                             K, interpret=True)
    L, cmax = len(WIDTHS), max(WIDTHS)
    bsums = np.zeros((L, 2, cmax), np.float32)
    for l, (_, _, dgamma, dbeta) in enumerate(grads):
        bsums[l, 0, :WIDTHS[l]] = np.asarray(dbeta)
        bsums[l, 1, :WIDTHS[l]] = np.asarray(dgamma)
    refs = [(lp.kernel, lp.bias.reshape(1, -1), lp.scale.reshape(1, -1),
             lp.shift.reshape(1, -1)) for lp in layers]
    _, acts, xhats, masks = jsk._prefix(xj, refs, packed, L, EPS,
                                        jnp.float32)
    da_top = jsk._pool_grad(acts[-1], dout, K)
    captured, _ = jsk._backprop_to(refs, packed, jnp.asarray(bsums), acts,
                                   xhats, masks, da_top, 0, L, R,
                                   jnp.float32)
    t = lambda v: torch.from_numpy(np.array(v, np.float32))
    packed = t(packed)
    ay, by = {}, {}
    for l, (lp, w) in enumerate(zip(layers, WIDTHS)):
        mean, inv = packed[l, 0, :w], packed[l, 1, :w]
        ay[l] = inv * t(lp.scale)
        by[l] = t(lp.shift) - mean * ay[l]
    return dict(x=t(x), W=[t(lp.kernel) for lp in layers],
                b=[t(lp.bias) for lp in layers],
                h=[t(a) for a in acts[:L]],
                dp={li: t(dp) for li, dp in captured}, ay=ay, by=by)


def _product(c, name):
    """(a, b, kind) of one of the kernel's tensor-core products."""
    W, h, dp = c["W"], c["h"], c["dp"]
    return {"p1 = h0 W1": (h[1], W[1], "row"),
            "p2 = h1 W2": (h[2], W[2], "row"),
            "da1 = dp2 W2^T": (dp[2], W[2].T.contiguous(), "row"),
            "da0 = dp1 W1^T": (dp[1], W[1].T.contiguous(), "row"),
            "dW2 = h1^T dp2": (h[2], dp[2], "acc"),
            "dW1 = h0^T dp1": (h[1], dp[1], "acc"),
            "dW0 = x^T dp0": (h[0], dp[0], "acc")}[name]


def _bar(k, a, b, kind):
    """How far past its phase 2 bar the product k of a and b is (<= 1
    passes): acc products are h^T dp."""
    ref = a.double().T @ b.double() if kind == "acc" else \
        a.double() @ b.double()
    scale = float(ref.abs().max())
    d = (k.double() - ref).abs()
    if kind == "acc":
        return float(d.max()) / (1e-4 * scale)
    return float((d / (1e-5 * ref.abs() + 1e-5 * scale)).max())


NAMES = ["p1 = h0 W1", "p2 = h1 W2", "da1 = dp2 W2^T", "da0 = dp1 W1^T",
         "dW2 = h1^T dp2", "dW1 = h0^T dp1", "dW0 = x^T dp0"]


@pytest.mark.parametrize("name", NAMES)
def test_b9_tf32_products_meet_the_bars(chain, name):
    """Each tensor-core product of the kernel, in its order of k8 steps
    (and for dW its per-tile f32 sums with float64 carries), within phase
    2's f32 bar of float64."""
    a, b, kind = _product(chain, name)
    k = dw_b9(a, b) if kind == "acc" else mm_b9(a, b)
    assert _bar(k, a, b, kind) <= 1.0


@pytest.mark.parametrize("name", NAMES)
def test_b9_one_pass_fails_the_bars(chain, name):
    """Single-pass TF32 (~2^-11 relative per operand) misses each bar that
    the three passes meet."""
    a, b, kind = _product(chain, name)
    k = mm_1x(a.T.contiguous(), b).double() if kind == "acc" else mm_1x(a, b)
    assert _bar(k, a, b, kind) > 1.0


def near_zero(p, ay, by, S, kdim):
    """sa_fused.cu's near_zero on whole tensors (f32 ops as the kernel's):
    (y, the window around 0)."""
    pa = p * ay
    win = (4.0 * kdim + 64.0) * 2.0 ** -24 * 1.01 * S * ay.abs() + \
        2.0 ** -22 * (pa.abs() + by.abs())
    return pa + by, win


def test_b9_mask_redo_matches_the_k_order_chain(chain):
    """Layer 1's pre-activation as the kernel makes it: the tensor cores'
    p, and where near_zero flags it (S = tf32(h) |tf32(W)|, the kernel's
    one-pass sum) the k-order chain's p. The window covers the distance
    between the tensor cores' y and the chain's on every sum (with room:
    at most half of it), so no mask differs from the chain's; the redone
    sums are few (at most 1e-3 of them) and the flips the redo prevents
    are counted. The emulated steps round once, as the hardware's
    truncating adds within a step do not: the card's gap is measured by
    chip_ablate.py tc_sums_tf."""
    h, W, b = chain["h"][1], chain["W"][1], chain["b"][1]
    ay, by = chain["ay"][1], chain["by"][1]
    p_tc = mm_b9(h, W) + b
    p_ch = mm_chain(h, W) + b
    S = (tf32(h).double() @ tf32(W).abs().double()).float()
    y_tc, win = near_zero(p_tc, ay, by, S, W.shape[0])
    y_ch = p_ch * ay + by
    flagged = y_tc.abs() <= win
    gap = (y_tc - y_ch).abs()
    assert float((gap / win).max()) <= 0.5
    moved = (y_tc > 0) != (y_ch > 0)
    assert not bool((moved & ~flagged).any())
    assert int(flagged.sum()) <= 1e-3 * flagged.numel()
    pk = torch.where(flagged, p_ch, p_tc)
    assert torch.equal(pk * ay + by > 0, y_ch > 0)
    print(f"layer-1 sums flagged for the k-order redo: "
          f"{int(flagged.sum())} of {flagged.numel()}; masks that differ "
          f"without it: {int(moved.sum())}; largest |y_tc - y_chain| / "
          f"window {float((gap / win).max()):.3f}")


def test_b9_pool_routing_changes_only_at_near_ties(chain):
    """The top layer's pool argmax on the tensor cores' p2 against the
    k-order chain's: every change lies at a near-tie (a distinct value
    within 1e-5 of the largest |z| below the group's max, or the max
    within it of 0), where chip_smoke.py zeroes the cotangent."""
    h, W, b = chain["h"][2], chain["W"][2], chain["b"][2]
    ay, by = chain["ay"][2], chain["by"][2]
    z_tc = (mm_b9(h, W) + b) * ay + by
    z_ch = (mm_chain(h, W) + b) * ay + by
    a_tc = torch.relu(z_tc).reshape(G, K, -1).argmax(1)
    a_ch = torch.relu(z_ch).reshape(G, K, -1).argmax(1)
    zg = z_ch.double().reshape(G, K, -1)
    zmax = zg.amax(1, keepdim=True)
    gap = zmax - zg
    tol = 1e-5 * float(z_ch.abs().max())
    near = (zmax[:, 0].abs() <= tol) | \
        ((zmax[:, 0] > 0) & ((gap > 0) & (gap <= tol)).any(1))
    changed = a_tc != a_ch
    assert not bool((changed & ~near & (zmax[:, 0] > 0)).any())
    print(f"pool argmax changes (tensor cores vs k order): "
          f"{int(changed.sum())} of {changed.numel()}, near-ties "
          f"{int(near.sum())}")
