"""The port's datagen against facl_tpu.datagen, on the CPU, at
tests/test_datagen.py's small sizes.

The JAX generator runs under jit, so its functions are compared here as
it runs them (``jax.jit``): there XLA turns a division by a constant into
a product with its f32 reciprocal, which the port forms too
(datagen/depth.py ``f32_reciprocal``). A true division differs by an ulp
in about a fifth of the back-projected values; the test counts the voxel
floors that moves (the same count in the port as in JAX eager against
jit), and holds the port's values equal to jit's.

Every function is held bit for bit: mask_depth, locate_motion,
backproject, rank_coefficients (n in {3, 10, 17, 60}, and .5 ties),
rank_pool, denoise, compact_nonzero; voxels_to_points and
appearance_frame with JAX's draws passed in; generate_clip end to end
with JAX's draws (``jax_draws`` re-derives JAX's ``split(key, 3)`` keys
and its ``randint`` for the counts the port passes); the frame cap;
batched against single; the sharded tree against the unsharded one on an
imageio PNG tree; the synthetic depth clips; FPS and
group_points_level2 with the start given. Then the port's own pipeline:
``cli.generate --synthetic`` -> pretrain with SwAV -> extract -> probe,
no JAX tree involved; and the new modules import no JAX and default to
the card.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import facl_tpu.datagen as J
import facl_tpu_torch.datagen as T
from facl_tpu.config import DatagenConfig as JaxDatagenConfig
from facl_tpu.data import synthetic as JS
from facl_tpu.datagen import depth as JD
from facl_tpu.datagen import pointize as JP
from facl_tpu.datagen import voxelize as JV
from facl_tpu_torch.config import DatagenConfig
from facl_tpu_torch.data import synthetic as TS

ROOT = Path(__file__).resolve().parents[1]


def small_cfg(**kw):
    """tests/test_datagen.py::small_cfg, in both packages' classes."""
    d = dict(grid_shape=(24, 24, 24), image_shape=(48, 64), sample_num=256,
             max_frames=8, num_appearance_frames=4,
             boundary_seg=(2, 1, 1, 1), voxel_size=60.0)
    d.update(kw)
    return JaxDatagenConfig(**d), DatagenConfig(**d)


def synthetic_frames(F=8, H=48, W=64, seed=0):
    """tests/test_datagen.py::synthetic_frames: a blob moving across the
    image with depth ~ 1000, plus a textured second blob."""
    frames = np.zeros((F, H, W), np.float32)
    tex = np.random.default_rng(seed).uniform(0, 40, size=(10, 12))
    for f in range(F):
        x0 = 8 + 3 * f + (seed % 4)
        frames[f, 12:36, x0:x0 + 16] = 900.0 + 10.0 * f + 5.0 * seed
        frames[f, 30:40, 40 - f:52 - f] = 1500.0 - 70.0 * f + tex
    return frames


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


def jax_draws(key, A):
    """A ``randint(n, shape)`` that returns JAX's draws for a clip keyed
    ``key``: generate_clip splits it into (raw, key, app) and the app key
    into A, one ``randint(k, (S,), 0, n)`` each; the port calls its draw
    function raw, key, then each appearance frame in that order, with the
    counts JAX's draws take (max(n_valid, 1))."""
    k_raw, k_key, k_app = jax.random.split(key, 3)
    keys = [k_raw, k_key] + list(jax.random.split(k_app, A))
    calls = iter(keys)

    def randint(n, shape):
        return _t(jax.random.randint(next(calls), shape, 0, n)).long()
    return randint


# -- depth ---------------------------------------------------------------

def test_mask_depth_and_locate_motion_match_jax(rng):
    frames = rng.uniform(0, 3000, size=(5, 48, 64)).astype(np.float32)
    frames[frames < 800] = 0.0
    frames[1] = 0.0                                   # empty frame
    frames[2, :, :30] = 0.0
    seg = (3, 2, 4, 1)
    want = jax.vmap(lambda d: JD.mask_depth(d, seg))(jnp.asarray(frames))
    got = T.mask_depth(_t(frames), seg)
    _eq(got, want)
    _eq(T.mask_depth(_t(frames[3]), seg), want[3])
    prev = np.roll(frames, 1, axis=0)
    _eq(T.locate_motion(_t(prev), _t(frames), 50.0, 300.0),
        jax.vmap(JD.locate_motion)(jnp.asarray(prev), jnp.asarray(frames)))


def test_backproject_matches_jax_jit_and_counts_true_division(rng):
    cfg_j, cfg_t = JaxDatagenConfig(), DatagenConfig()
    d = rng.uniform(500, 4000, size=(2, 424, 512)).astype(np.float32)
    d[:, :, :40] = 0.0
    pj, vj = jax.jit(jax.vmap(lambda x: JD.backproject(x, cfg_j)))(
        jnp.asarray(d))
    pt, vt = T.backproject(_t(d), cfg_t)
    _eq(pt, pj)
    _eq(vt, vj)
    # The finding: JAX eager (and the reference's numpy) divides; jit
    # multiplies by the reciprocal. The values that differs, and the 30 mm
    # voxel floors (from the frame's minimum, the clip origin's rule) it
    # moves, counted in JAX (eager vs jit) and in the port (a true
    # division vs the port's product): the same.
    pe = np.asarray(JD.backproject(jnp.asarray(d[0]), cfg_j)[0])
    pj0, pt0 = np.asarray(pj[0]), pt[0].numpy()
    xx = torch.arange(512, dtype=torch.float32)[None]
    yy = torch.arange(424, dtype=torch.float32)[:, None]
    D = _t(d[0])
    ptrue = torch.stack([(xx - cfg_t.cx) * D / cfg_t.fx,
                         (yy - cfg_t.cy) * D / cfg_t.fy, D], -1) \
        .reshape(-1, 3).numpy()
    ptrue[~vt[0].numpy()] = 0.0
    np.testing.assert_array_equal(ptrue, pe)
    o = pj0[vt[0].numpy()].min(0)

    def floors(p):
        return np.floor((p - o) * np.float32(1.0 / 30.0))
    differ = int((pe != pj0).sum())
    moved = int((floors(pe) != floors(pj0)).any(-1).sum())
    assert differ == int((ptrue != pt0).sum())
    assert moved == int((floors(ptrue) != floors(pt0)).any(-1).sum())
    assert 0.1 < differ / pe[:, :2].size < 0.3, differ
    assert moved < 10, moved           # 0 on these 434176 values


# -- voxelize ------------------------------------------------------------

@pytest.mark.parametrize("n", [3, 10, 17, 60, 7.5, 12.5])
def test_rank_coefficients_match_jax(n):
    """Integer clip lengths, and 7.5 / 12.5, whose window edges n/5,
    2n/5 ... land on .5: both round half to even."""
    want = JV.rank_coefficients(jnp.asarray(n, jnp.float32), 60, 5)
    _eq(T.rank_coefficients(torch.tensor(n, dtype=torch.float32), 60, 5),
        want)
    _eq(T.rank_coefficients(torch.tensor([n, n]), 60, 5)[1], want)


def test_rank_pool_matches_jax(rng):
    """Points clustered so voxels repeat within and across frames, some
    out of range and invalid (tests/test_datagen.py:297-330)."""
    cfg_j, cfg_t = (c(grid_shape=(16, 12, 12), voxel_size=30.0,
                      max_frames=11)
                    for c in (JaxDatagenConfig, DatagenConfig))
    F, P = 11, 200
    pts = rng.uniform(-40, 16 * 30 + 40, size=(F, P, 3)).astype(np.float32)
    pts[:, :P // 3] = rng.uniform(0, 100, size=(F, P // 3, 3))
    valid = rng.uniform(size=(F, P)) > 0.2
    kpts = rng.uniform(0, 300, size=(F, P, 3)).astype(np.float32)
    kvalid = rng.uniform(size=(F, P)) > 0.5
    origin = np.array([-3.0, 1.5, 0.25], np.float32)
    di, dk = jax.jit(lambda *a: JV.rank_pool(*a, cfg_j))(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(kpts),
        jnp.asarray(kvalid), jnp.asarray(9), jnp.asarray(origin))
    tdi, tdk = T.rank_pool(_t(pts), _t(valid), _t(kpts), _t(kvalid), 9,
                           _t(origin), cfg_t)
    _eq(tdi, di)
    _eq(tdk, dk)
    idx, v = T.voxel_indices(_t(pts[0]), _t(valid[0]), _t(origin), 30.0,
                             cfg_t.grid_shape)
    jidx, jv = jax.jit(lambda *a: JV.voxel_indices(*a, 30.0, (16, 12, 12)))(
        jnp.asarray(pts[0]), jnp.asarray(valid[0]), jnp.asarray(origin))
    _eq(idx, jidx)
    _eq(v, jv)
    _eq(T.scatter_occupancy(idx, v, (16, 12, 12)),
        JV.scatter_occupancy(jidx, jv, (16, 12, 12)))


@pytest.mark.parametrize("threshold", [1, 5, 6, 27])
def test_denoise_matches_jax(rng, threshold):
    g = rng.uniform(size=(11, 9, 10)).astype(np.float32)
    g[g < 0.55] = 0.0
    g[2:6, 2:6, 2:6] = 3.0
    _eq(T.denoise(_t(g), threshold), JV.denoise(jnp.asarray(g), threshold))
    _eq(T.denoise(_t(np.stack([g, g[::-1].copy()])), threshold)[0],
        JV.denoise(jnp.asarray(g), threshold))


# -- pointize ------------------------------------------------------------

@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_compact_nonzero_matches_jax(rng, p):
    m = rng.uniform(size=(97,)) < p
    ids, n = T.compact_nonzero(_t(m))
    jids, jn = JP.compact_nonzero(jnp.asarray(m))
    _eq(ids, jids)
    assert int(n) == int(jn)


@pytest.mark.parametrize("nvox", [5, 40, 600])
def test_voxels_to_points_with_jax_draws(rng, nvox):
    """Fewer candidates than S (keep all, then extras), and more (draws
    with replacement); with and without a select mask."""
    di = np.zeros((3, 12, 10, 8), np.float32)
    flat = di.reshape(3, -1)
    cols = rng.choice(flat.shape[1], size=nvox, replace=False)
    flat[rng.integers(0, 3, size=nvox), cols] = rng.uniform(
        -5, 5, size=nvox).astype(np.float32)
    mask = rng.uniform(size=(12, 10, 8)) < 0.5
    key = jax.random.PRNGKey(nvox)
    for sel in (None, mask):
        jpts, jn = JP.voxels_to_points(
            key, jnp.asarray(di), 64,
            None if sel is None else jnp.asarray(sel))
        tpts, tn = T.voxels_to_points(
            lambda n, s: _t(jax.random.randint(key, s, 0, n)).long(),
            _t(di), 64, None if sel is None else _t(sel))
        _eq(tpts, jpts)
        assert int(tn) == int(jn)


def test_appearance_frame_and_normalization_with_jax_draws(rng):
    pts = rng.uniform(0, 900, size=(300, 3)).astype(np.float32)
    valid = rng.uniform(size=(300,)) < 0.4
    origin = np.array([-10.5, 3.25, 1.0], np.float32)
    di0 = rng.uniform(-50, 50, size=(16, 17, 18)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda *a: JP.appearance_frame(key, *a, 60.0,
                                                  jnp.asarray(di0), 128))(
        jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(origin))
    got = T.appearance_frame(
        lambda n, s: _t(jax.random.randint(key, s, 0, n)).long(),
        _t(pts), _t(valid), _t(origin), 60.0, _t(di0), 128)
    _eq(got, want)
    cloud = rng.uniform(-3, 9, size=(64, 8)).astype(np.float32)
    jstats = jax.jit(JP.normalization_stats)(jnp.asarray(cloud))
    tstats = T.normalization_stats(_t(cloud))
    for a, b in zip(tstats, jstats):
        _eq(a, b)
    _eq(T.apply_normalization(_t(cloud), *tstats),
        jax.jit(JP.apply_normalization)(jnp.asarray(cloud), *jstats))


# -- the clip ------------------------------------------------------------

CLIPS = {"moving": (synthetic_frames(), 8),
         "short": (synthetic_frames(F=8, seed=3), 5),
         "empty": (np.zeros((8, 48, 64), np.float32), 8),
         "still": (np.repeat(synthetic_frames(F=1, seed=1), 8, 0), 8)}


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_generate_clip_matches_jax_with_its_draws(name):
    cfg_j, cfg_t = small_cfg()
    frames, n = CLIPS[name]
    key = jax.random.PRNGKey(7)
    want = J.generate_clip(key, jnp.asarray(frames), jnp.asarray(n,
                                                                  jnp.int32),
                           cfg_j, 8)
    got = T.generate_clip(_t(frames), n, cfg_t, jax_draws(key, 4))
    assert set(got) == set(want)
    for k in want:
        _eq(got[k], want[k], k)
    assert np.isfinite(got["raw"].numpy()).all()


def test_frame_cap_matches_jax():
    cfg_j, cfg_t = small_cfg()
    frames = synthetic_frames(F=13, seed=2)
    for tag in ("S001C002P003R001A004", "x"):
        jbuf, jF, _ = J.ClipGenerator(cfg_j, max_frames=5,
                                      seed=4)._prepare(frames, tag)
        tbuf, tF, _ = T.ClipGenerator(cfg_t, max_frames=5, seed=4,
                                      device="cpu").prepare(frames, tag)
        assert tF == jF == 5
        np.testing.assert_array_equal(tbuf, jbuf)
    # Untagged: the generator's own sequential stream, as JAX's.
    jg = J.ClipGenerator(cfg_j, max_frames=5, seed=4)
    tg = T.ClipGenerator(cfg_t, max_frames=5, seed=4, device="cpu")
    for _ in range(3):
        np.testing.assert_array_equal(tg.prepare(frames, None)[0],
                                      jg._prepare(frames, None)[0])


def test_batched_equals_single():
    _, cfg = small_cfg()
    clips = [synthetic_frames(F=12, seed=s) for s in range(3)]
    tags = ["vidA", "vidB", "vidC"]
    outs = T.ClipGenerator(cfg, max_frames=6, seed=1,
                           device="cpu").from_frames_batch(clips, tags)
    gen = T.ClipGenerator(cfg, max_frames=6, seed=1, device="cpu")
    for clip, tag, got in zip(clips, tags, outs):
        want = gen.from_frames(clip, tag=tag)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=tag + k)
    # Untagged clips draw in clip order, batched or not.
    a = T.ClipGenerator(cfg, max_frames=6, seed=1, device="cpu")
    b = T.ClipGenerator(cfg, max_frames=6, seed=1, device="cpu")
    batch = a.from_frames_batch(clips[:2])
    for clip, got in zip(clips[:2], batch):
        np.testing.assert_array_equal(got["app"], b.from_frames(clip)["app"])


def _png_tree(tmp_path, n):
    imageio = pytest.importorskip("imageio.v2")
    for vi in range(n):
        setup = f"nturgbd_depth_masked_s00{1 + vi % 2}"
        vid = (tmp_path / "data" / setup / "nturgb+d_depth_masked" /
               f"S00{1 + vi % 2}C001P001R001A{vi + 1:03d}")
        vid.mkdir(parents=True)
        for i, fr in enumerate(synthetic_frames(F=9, seed=vi)):
            imageio.imwrite(str(vid / f"f{i:03d}.png"), fr.astype(np.uint16))
    return str(tmp_path / "data")


def _tree(d):
    return {str(p.relative_to(d)): np.load(p)
            for p in sorted(Path(d).rglob("*.npy"))}


def test_sharded_and_batched_trees_equal_unsharded(tmp_path):
    _, cfg = small_cfg(resolutions=(8, 4))
    data = _png_tree(tmp_path, 5)
    out = tmp_path / "one"
    assert T.generate_dataset(data, str(out), cfg, seed=2,
                              device="cpu") == 10
    want = _tree(out)
    assert len(want) == 30
    for i in range(3):
        T.generate_dataset(data, str(tmp_path / "sh"), cfg, seed=2, shard=i,
                           num_shards=3, clip_batch=2, device="cpu")
    got = _tree(tmp_path / "sh")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert T.generate_dataset(data, str(tmp_path / "lim"), cfg, seed=2,
                              limit=3, clip_batch=2, device="cpu") == 3
    raws = list((tmp_path / "lim" / "Resolution8" / "raw").glob("*.npy"))
    assert len(raws) == 3
    frames = T.load_png_frames(os.path.join(
        data, "nturgbd_depth_masked_s001", "nturgb+d_depth_masked",
        "S001C001P001R001A001"))
    np.testing.assert_array_equal(
        frames, synthetic_frames(F=9, seed=0).astype(np.uint16))


# -- synthetic clips -----------------------------------------------------

@pytest.mark.parametrize("style,action", [("instance", None),
                                          ("instance", 3),
                                          ("blobs", 2),
                                          ("reference_window", 5),
                                          ("reference_window", None)])
def test_synthetic_depth_clips_equal_jax(style, action):
    for seed in range(2):
        kw = dict(n_frames=7, shape=(96, 128), action=action,
                  num_actions=6, style=style)
        np.testing.assert_array_equal(
            TS.synthetic_depth_clip(np.random.default_rng(seed), **kw),
            JS.synthetic_depth_clip(np.random.default_rng(seed), **kw))
    assert list(TS.synthetic_ntu_names(9, np.random.default_rng(1))) == \
        list(JS.synthetic_ntu_names(9, np.random.default_rng(1)))


def test_synthetic_trees_equal_jax(tmp_path):
    TS.write_random_tree(str(tmp_path / "t"), 3, seed=5, sample_num=16,
                         app_frames=2)
    JS.write_random_tree(str(tmp_path / "j"), 3, seed=5, sample_num=16,
                         app_frames=2)
    t, j = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert set(t) == set(j) and len(t) == 27
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])
    pytest.importorskip("imageio.v2")
    kw = dict(num_videos=2, seed=3, n_frames=3, shape=(96, 128))
    assert TS.write_synthetic_png_tree(str(tmp_path / "tp"), **kw) == \
        JS.write_synthetic_png_tree(str(tmp_path / "jp"), **kw)
    tp = sorted((tmp_path / "tp").rglob("*.png"))
    assert len(tp) == 6
    for p in tp:
        q = tmp_path / "jp" / p.relative_to(tmp_path / "tp")
        assert p.read_bytes() == q.read_bytes()


# -- FPS and the second-level grouping -----------------------------------

def test_fps_matches_jax_with_the_start_given(rng):
    from facl_tpu.ops import fps as JF
    from facl_tpu_torch.ops import fps as TF
    xyz = rng.normal(size=(3, 60, 3)).astype(np.float32)
    xyz[0, 10] = xyz[0, 11]                     # a repeated point
    key = jax.random.PRNGKey(5)
    keys = jax.random.split(key, 3)
    starts = [int(jax.random.randint(k, (), 0, 60)) for k in keys]
    _eq(TF.fps_batched(_t(xyz), 17, torch.tensor(starts)),
        JF.fps_batched(key, jnp.asarray(xyz), 17))
    _eq(TF.farthest_point_sampling(_t(xyz[1]), 9, start=starts[1]),
        JF.farthest_point_sampling(keys[1], jnp.asarray(xyz[1]), 9))
    pts = rng.normal(size=(3, 60, 5)).astype(np.float32)
    _eq(TF.fps_reorder(_t(pts), 12, torch.tensor(starts)),
        JF.fps_reorder(key, jnp.asarray(pts), 12))
    g = torch.Generator().manual_seed(0)
    a = TF.fps_batched(_t(xyz), 5, generator=g)
    assert a.shape == (3, 5) and len(set(a[2].tolist())) == 5


def test_group_points_level2_matches_jax(rng):
    from facl_tpu.ops.grouping import group_points_level2 as jl2
    from facl_tpu_torch.ops.grouping import group_points_level2 as tl2
    feats = rng.normal(size=(2, 80, 3 + 9)).astype(np.float32)
    feats[..., :3] *= 0.3
    jn, jc = jl2(jnp.asarray(feats), num_centroids=16, knn_k=8,
                 radius_sq=0.11)
    tn, tc = tl2(_t(feats), 16, 8, 0.11)
    _eq(tc, jc)
    assert tn.shape == jn.shape == (2, 16, 8, 12)
    # Neighbour order within K may differ between routes (ops/grouping.py):
    # compare each neighbourhood as a sorted set of rows.
    srt = lambda a: np.sort(np.asarray(a).reshape(-1, 8, 12), axis=1)
    np.testing.assert_allclose(srt(tn), srt(jn), rtol=1e-6, atol=1e-6)


# -- the port's own pipeline and its isolation ---------------------------

def test_port_generate_pretrain_extract_probe(tmp_path, capsys):
    """generate --synthetic (the port's generator, on the CPU) -> pretrain
    with SwAV on (queue from epoch 0) -> extract -> probe: no JAX tree."""
    from facl_tpu_torch.cli import extract, generate, pretrain, probe
    from facl_tpu_torch.config import Config, GroupingConfig, LossConfig, \
        ModelConfig
    tree = str(tmp_path / "tree")
    assert generate.main(["--synthetic", "8", "--out", tree, "--device",
                          "cpu"]) == 8
    raws = sorted(os.listdir(os.path.join(tree, "Resolution60", "raw")))
    assert len(raws) == 8
    raw = np.load(os.path.join(tree, "Resolution60", "raw", raws[0]))
    assert raw.shape == (2048, 8) and np.isfinite(raw).all()
    cfg = Config(
        grouping=GroupingConfig(num_centroids=8, knn_k=8, radius_sq=10.0),
        model=ModelConfig(sa_widths=(8, 16), stage2_widths=(16, 32),
                          fc_hidden=32, embed_dim=16, num_prototypes=8),
        loss=LossConfig(use_swav=True, swav_queue_start_epoch=0))
    cfg_file = tmp_path / "swav.json"
    cfg_file.write_text(cfg.to_json())
    feats = {}
    for stream in ("motion", "appearance"):
        ck = str(tmp_path / f"ck_{stream}")
        common = ["--root", tree, "--stream", stream, "--batch-size", "2",
                  "--dtype", "float32", "--config", str(cfg_file),
                  "--device", "cpu"]
        hist = pretrain.main(common + ["--epochs", "1", "--out", ck])
        assert np.isfinite(hist[0]["loss"]) and "loss_swav" in hist[0]
        feats[stream] = str(tmp_path / f"feat_{stream}")
        assert extract.main(common + ["--checkpoint", ck, "--out",
                                      feats[stream]]) == 8
    capsys.readouterr()
    best = probe.main(["--root", tree, "--motion-features", feats["motion"],
                       "--appearance-features", feats["appearance"],
                       "--epochs", "2", "--device", "cpu"])
    assert np.isfinite(best["top1"])


def test_new_modules_import_no_jax_and_default_to_the_card():
    code = ("import sys; before = set(sys.modules); "
            "import facl_tpu_torch.datagen, facl_tpu_torch.cli.generate, "
            "facl_tpu_torch.data.synthetic, facl_tpu_torch.ops.fps, "
            "facl_tpu_torch.losses.sinkhorn, facl_tpu_torch.losses.cld; "
            "new = set(sys.modules) - before; "
            "bad = sorted(m for m in new if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'facl_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    if torch.cuda.is_available():
        return
    from facl_tpu_torch.cli import generate
    _, cfg = small_cfg()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.ClipGenerator(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate.main(["--synthetic", "1", "--out", "unused"])
