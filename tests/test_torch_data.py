"""The port's data path against the JAX package's, on the CPU: the NTU
split tables, the dataset index and its loaded arrays (native loader and
NumPy) over a tree written by the JAX generator, the deterministic
transforms, the loader's batch order; and the random transforms and the
10-crop factory by invariants (torch and JAX draw different numbers, so
crop parity is held by what each crop must satisfy, ROADMAP Queue 1
item 11).

Tolerances: the transforms at 1e-6 (absolute and relative, f32); loaded
arrays bit-equal; crop invariants exact where a crop copies rows, and
within the jitter clip (0.05 a jitter, summed) where it jitters."""
import math

import jax
import numpy as np
import pytest
import torch

from facl_tpu import data as JD
from facl_tpu.config import DataConfig as JaxDataConfig
from facl_tpu.config import DatagenConfig
from facl_tpu.ops import transforms as JT
from facl_tpu_torch import data as TD
from facl_tpu_torch.config import DataConfig
from facl_tpu_torch.data import native
from facl_tpu_torch.data.crops import ClipSources
from facl_tpu_torch.ops import transforms as T

CLIP = 0.05


def _names(rng, n):
    """NTU names over both datasets' ranges, unique, unsorted."""
    out = set()
    while len(out) < n:
        s, c, p, r, a = (rng.integers(1, 33), rng.integers(1, 4),
                         rng.integers(1, 107), rng.integers(1, 3),
                         rng.integers(1, 121))
        out.add(f"S{s:03d}C{c:03d}P{p:03d}R{r:03d}A{a:03d}")
    return sorted(out)


def test_split_tables_match_jax(rng):
    names = _names(rng, 400) + ["prefix_S001C002P003R001A060_rgb.avi"]
    jinfo = [JD.parse_name(n) for n in names]
    tinfo = [TD.parse_name(n) for n in names]
    for j, t in zip(jinfo, tinfo):
        assert (t.name, t.setup, t.camera, t.performer, t.replication,
                t.action, t.label) == (j.name, j.setup, j.camera,
                                       j.performer, j.replication, j.action,
                                       j.label)
    for dataset in ("ntu60", "ntu120"):
        for protocol in ("xsub", "xview", "xset"):
            assert TD.split_videos(tinfo, protocol, dataset) == \
                JD.split_videos(jinfo, protocol, dataset)
    assert TD.validation_split(tinfo) == JD.validation_split(jinfo)
    assert (TD.TRAIN_IDS_60, TD.TRAIN_IDS_120, TD.TRAIN_CAMERAS,
            TD.TRAIN_SETUPS) == (JD.TRAIN_IDS_60, JD.TRAIN_IDS_120,
                                 JD.TRAIN_CAMERAS, JD.TRAIN_SETUPS)
    with pytest.raises(ValueError, match="protocol"):
        TD.split_videos(tinfo, "xfoo")
    with pytest.raises(ValueError, match="NTU"):
        TD.parse_name("clip.npy")
    pku = ["0291-02R_A05.npy", "0001-01M_A51.npy", "0002-03L_A01.npy"]
    from facl_tpu.data.pku_mmd import parse_pku_name as jp
    assert [TD.parse_pku_name(n) .__dict__ for n in pku] == \
        [jp(n).__dict__ for n in pku]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("data_tree")
    dg = DatagenConfig(grid_shape=(24, 24, 24), image_shape=(48, 64),
                       sample_num=256, num_appearance_frames=4,
                       voxel_size=80.0, resolutions=(60, 30, 10))
    names = JD.write_synthetic_dataset(str(root), num_videos=8, seed=1,
                                       datagen_cfg=dg)
    return str(root), names


SPLITS = ("train", "test", "validation", "train_with_validation")


@pytest.mark.parametrize("stream", ["motion", "appearance"])
def test_dataset_matches_jax(tree, stream, monkeypatch):
    root, names = tree
    jcfg = JaxDataConfig(stream=stream, protocol="xsub")
    tcfg = DataConfig(stream=stream, protocol="xsub")
    assert native.native_available()     # g++ is on this machine
    for split in SPLITS:
        jd = JD.NTUPointDataset(root, jcfg, split=split)
        td = TD.NTUPointDataset(root, tcfg, split=split)
        assert td.names == jd.names and td.indices == jd.indices
        assert [i.label for i in td.infos] == [i.label for i in jd.infos]
        if not td.indices:
            continue
        idxs = list(range(len(td)))[::-1]
        jsrc, jlab, jnames = jd.load_batch(idxs)
        for load in (td.load_batch_native, td.load_batch_numpy,
                     td.load_batch):
            tsrc, tlab, tnames = load(idxs)
            assert tnames == jnames
            np.testing.assert_array_equal(tlab, jlab)
            for t, j in zip(tsrc, jsrc):
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(t.numpy(), j)
        src, label, name = td.load_sources(idxs[0])
        assert (label, name) == (int(jlab[0]), jnames[0])
        for t, j in zip(src, jsrc):
            np.testing.assert_array_equal(t.numpy(), j[0])
    # Without a toolchain the dataset loads through NumPy.
    monkeypatch.setattr(native, "native_available", lambda: False)
    td = TD.NTUPointDataset(root, tcfg)
    called = []
    monkeypatch.setattr(td, "load_batch_native",
                        lambda *a: called.append(a))
    srcs, _, _ = td.load_batch([0])
    assert not called and srcs.points.shape[0] == 1


def test_native_loader_rejects_a_wrong_shape(tree, tmp_path):
    root, names = tree
    td = TD.NTUPointDataset(root, DataConfig(stream="motion"))
    paths = [p[0] for p in map(td.paths, td.names[:2])]
    out = torch.empty(2, 128, 8)
    with pytest.raises(ValueError, match="shape"):
        native.load_into(paths, out)
    # A float64 file (which the native parser converts) and a big-endian
    # one (which it leaves to NumPy) load to the same float32 rows.
    a = np.load(paths[0])
    p64, pbe = str(tmp_path / "a64.npy"), str(tmp_path / "abe.npy")
    np.save(p64, a.astype(np.float64))
    np.save(pbe, a.astype(">f4"))
    out = torch.empty(3, *a.shape)
    native.load_into([paths[0], p64, pbe], out)
    for row in out:
        np.testing.assert_array_equal(row.numpy(), a.astype(np.float32))


def test_deterministic_transforms_match_jax(rng):
    pts = rng.normal(size=(3, 50, 6)).astype(np.float32)
    tp = torch.from_numpy(pts)
    for tfn, jfn in ((T.mirror_x, JT.mirror_x),
                     (lambda p: T.rotate_y_fixed(p, 1.5),
                      lambda p: JT.rotate_y_fixed(p, 1.5)),
                     (lambda p: T.rotate_y_fixed(p, -0.5),
                      lambda p: JT.rotate_y_fixed(p, -0.5)),
                     (T.rank_transform, JT.rank_transform),
                     (lambda p: T.rank_transform(p, 0.7),
                      lambda p: JT.rank_transform(p, 0.7)),
                     (T.normalize_xyz, JT.normalize_xyz)):
        np.testing.assert_allclose(tfn(tp).numpy(),
                                   np.asarray(jfn(jax.numpy.asarray(pts))),
                                   rtol=1e-6, atol=1e-6)
    # The rotation matrices alike.
    ang = rng.uniform(-3, 3, size=5).astype(np.float32)
    np.testing.assert_allclose(T._rot_y(torch.from_numpy(ang)).numpy(),
                               np.asarray(JT._rot_y(jax.numpy.asarray(ang))), rtol=1e-6,
                               atol=1e-6)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_random_transforms_hold_their_invariants(rng):
    B, N = 4, 300
    pts = torch.from_numpy(rng.normal(size=(B, N, 6)).astype(np.float32))
    xyz, rest = pts[..., :3], pts[..., 3:]
    j = T.jitter(_gen(), pts, 0.01, CLIP)
    d = j[..., :3] - xyz
    assert float(d.abs().max()) <= CLIP + 1e-6 and float(d.std()) > 0.005
    assert torch.equal(j[..., 3:], rest)
    r = T.reverse_transform(_gen(), pts)
    assert float((r[..., 0] + pts[..., 0]).abs().max()) <= CLIP + 1e-6
    for fn in (lambda p: T.rotate_y_random(_gen(), p, 0.8),
               lambda p: T.rotate_y_uniform(_gen(), p)):
        o = fn(pts)
        torch.testing.assert_close(o[..., 1], pts[..., 1])
        torch.testing.assert_close(o[..., [0, 2]].norm(dim=-1),
                                   pts[..., [0, 2]].norm(dim=-1))
        assert torch.equal(o[..., 3:], rest)
    o = T.rotate_perturbation(_gen(), pts)
    torch.testing.assert_close(o[..., :3].norm(dim=-1), xyz.norm(dim=-1))
    # Angles are per cloud: the rotation differs between clouds.
    o = T.rotate_y_random(_gen(), pts[:1].expand(B, N, 6))
    assert not torch.allclose(o[0], o[1])
    for fn, lo, hi in ((T.scale_random, 0.5, 1.5),):
        s = fn(_gen(), pts, lo, hi)[..., :3] / xyz
        assert float(s.min()) >= lo - 1e-5 and float(s.max()) <= hi + 1e-5
        assert float((s - s[:, :1, :1]).abs().max()) < 1e-4
    t = T.shift_random(_gen(), pts, 0.1)[..., :3] - xyz
    assert float(t.abs().max()) <= 0.1 + 1e-6
    assert float((t - t[:, :1]).abs().max()) < 1e-5
    m = T.motion_rescale(_gen(), pts)
    s = m[..., 3:] / rest
    assert torch.equal(m[..., :3], xyz)
    assert 0.2 - 1e-5 <= float(s.min()) and float(s.max()) <= 0.9 + 1e-5
    # resample: rows of the cloud, drawn per cloud with replacement.
    sub = T.resample(_gen(), pts, 1000)
    assert sub.shape == (B, 1000, 6)
    for b in range(B):
        assert _rows_in(sub[b], pts[b])
    assert not torch.equal(T.resample(_gen(), pts[:1].expand(2, N, 6),
                                      50)[0],
                           T.resample(_gen(), pts[:1].expand(2, N, 6),
                                      50)[1])


def _rows_in(rows, table):
    """Every row of ``rows`` equals some row of ``table``, exactly."""
    eq = (rows[:, None, :] == table[None, :, :]).all(-1)
    return bool(eq.any(1).all())


def test_masked_resample_draws_only_masked_rows_and_never_raises(rng):
    B, N = 3, 200
    pts = torch.from_numpy(rng.normal(size=(B, N, 4)).astype(np.float32))
    mask = torch.zeros(B, N)
    mask[0, [3, 17, 150]] = 1.0
    mask[1, :] = 1.0                  # cloud 2: all masked out
    out = T.masked_resample(_gen(), pts, mask, 3000)
    assert _rows_in(out[0], pts[0, [3, 17, 150]])
    counts = [int((out[0] == pts[0, i]).all(-1).sum()) for i in (3, 17, 150)]
    assert min(counts) > 800                      # uniform among the three
    assert _rows_in(out[1], pts[1]) and _rows_in(out[2], pts[2])
    # The all-masked cloud falls back to uniform over every row.
    hit = (out[2][:, None] == pts[2][None]).all(-1).any(0)
    assert int(hit.sum()) > 0.9 * N
    view = T.temporal_channel_view(_gen(), torch.zeros(2, 64, 8), 4, 16)
    assert view.shape == (2, 16, 4) and not bool(view.any())


def _sources(rng, B, app=False):
    """Batched sources whose channel 3 identifies each row; ti channels
    zero on about half the rows (zero everywhere for the last video)."""
    def cloud(n, c):
        a = rng.normal(size=(B, n, c)).astype(np.float32)
        a[..., 3] = rng.uniform(1, 2, size=(B, n)) * np.sign(
            rng.normal(size=(B, n)))
        return torch.from_numpy(a)
    raw = cloud(256, 8)
    for ch in (4, 7):
        raw[..., ch] *= torch.from_numpy(
            (rng.uniform(size=(B, 256)) < 0.5).astype(np.float32))
    raw[-1, :, 4] = 0.0
    raw[-1, :, 7] = 0.0
    pts = cloud(4 * 256, 4) if app else raw
    return ClipSources(pts, cloud(256, 8), raw, cloud(200, 4 if app else 8),
                       cloud(100, 4 if app else 8))


def _match(crop, table, tol, mirror=False):
    """Each crop row's source row (by channel 3, unique in the table)
    exists, and the crop's xyz is within ``tol`` of it (x negated with
    ``mirror``)."""
    eq = crop[:, None, 3] == table[None, :, 3]
    assert bool((eq.sum(1) == 1).all())
    src = table[eq.float().argmax(1)]
    x = -crop[:, 0] if mirror else crop[:, 0]
    d = torch.stack([x - src[:, 0], crop[:, 1] - src[:, 1],
                     crop[:, 2] - src[:, 2]], -1)
    assert float(d.abs().max()) <= tol + 1e-5
    return src


@pytest.mark.parametrize("app", [False, True])
def test_crop_factory_invariants(rng, app):
    B = 3
    src = _sources(rng, B, app)
    cfg = DataConfig(num_points=128)
    crops = TD.make_crops_batch(_gen(5), src, cfg)
    assert crops.shape == (10, B, 128, 4) and crops.dtype == torch.float32
    assert torch.equal(crops, TD.make_crops_batch(_gen(5), src, cfg))
    assert not torch.equal(crops, TD.make_crops_batch(_gen(6), src, cfg))
    for b in range(B):
        c = crops[:, b]
        p4, k4 = src.points[b, :, :4], src.key_points[b, :, :4]
        assert _rows_in(c[0], p4)                               # raw
        _match(c[1], p4, 2 * CLIP, mirror=True)                 # rev
        _match(c[2], k4, CLIP)                                  # key1
        _match(c[3], k4, 2 * CLIP, mirror=True)                 # key2
        assert not _rows_in(c[2], p4)
        for i in (4, 5):                                        # rot1/2
            eq = c[i][:, None, 3] == p4[None, :, 3]
            s = p4[eq.float().argmax(1)]
            assert float((c[i][:, 1] - s[:, 1]).abs().max()) <= CLIP + 1e-5
            r_c = c[i][:, [0, 2]].norm(dim=-1)
            r_s = s[:, [0, 2]].norm(dim=-1)
            assert float((r_c - r_s).abs().max()) <= math.sqrt(2) * CLIP \
                + 1e-5
        t = src.temporal_source[b]
        for i, ch in ((6, 4), (7, 7)):                          # ti1/2
            view = torch.cat([t[:, :3], t[:, ch:ch + 1]], -1)
            nz = view[view[:, 3] != 0]
            assert _rows_in(c[i], nz if len(nz) else view)
            if len(nz) == 0:                 # the all-masked video
                assert b == B - 1 and not bool(c[i][:, 3].any())
            else:
                assert bool((c[i][:, 3] != 0).all())
        assert _rows_in(c[8], src.res30[b, :, :4])              # res30
        assert _rows_in(c[9], src.res10[b, :, :4])              # res10
    one = TD.make_crops(_gen(5), ClipSources(*(f[0] for f in src)),
                        num_points=128)
    assert one.shape == (10, 128, 4) and _rows_in(one[0],
                                                  src.points[0, :, :4])


def test_simclr_crops(rng):
    src = _sources(rng, 1)
    v = TD.make_simclr_crops(_gen(), ClipSources(*(f[0] for f in src)), 64)
    assert v.shape == (2, 64, 4) and bool(torch.isfinite(v).all())
    pts = torch.from_numpy(rng.normal(size=(2, 64, 4)).astype(np.float32))
    a = TD.random_augment(_gen(), pts)
    assert torch.equal(a[..., 3], pts[..., 3])
    # Rotation about y, scale in [0.6, 1.4), jitter: the y extent scales.
    ratio = a[..., 1].std(1) / pts[..., 1].std(1)
    assert bool((ratio > 0.55).all() and (ratio < 1.45).all())


def test_crop_loader_yields_jax_batches_in_jax_order(tree):
    root, names = tree
    for stream in ("motion", "appearance"):
        jd = JD.NTUPointDataset(root, JaxDataConfig(stream=stream,
                                                    num_points=64))
        td = TD.NTUPointDataset(root, DataConfig(stream=stream,
                                                 num_points=64))
        assert len(td) % 4 and len(td) > 4         # a ragged last batch
        jl = JD.CropLoader(jd, 4, jax.random.PRNGKey(3), shuffle=False,
                           drop_last=False)
        tl = TD.CropLoader(td, 4, seed=3, shuffle=False, drop_last=False,
                           device="cpu")
        jb = [(lab.tolist(), nm) for _, lab, nm in jl.epoch(0)]
        tb = []
        for crops, lab, nm in tl.epoch(0):
            assert crops.shape == (10, len(nm), 64, 4)
            assert crops.device.type == "cpu"
            tb.append((lab.tolist(), nm))
        assert tb == jb
        again = [c for c, _, _ in tl.epoch(0)]
        assert all(torch.equal(a, b) for a, b in
                   zip(again, [c for c, _, _ in tl.epoch(0)]))
        assert not torch.equal(again[0], next(tl.epoch(1))[0])
    # Shuffled, drop_last: whole batches, a permutation per epoch.
    tl = TD.CropLoader(td, 2, seed=3, device="cpu")
    e0 = tl.batch_indices(0)
    assert all(len(b) == 2 for b in e0) and len(e0) == len(td) // 2
    assert sorted(sum(e0, [])) != sum(e0, []) or len(td) < 4
    assert e0 == tl.batch_indices(0)


def test_crop_loader_surfaces_producer_errors(tree, monkeypatch):
    root, _ = tree
    td = TD.NTUPointDataset(root, DataConfig())

    def broken(*a):
        raise OSError("disk gone")
    monkeypatch.setattr(td, "load_batch", broken)
    with pytest.raises(OSError, match="disk gone"):
        list(TD.CropLoader(td, 1, device="cpu").epoch(0))


def test_loader_needs_a_card_unless_told_otherwise(tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, _ = tree
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.CropLoader(TD.NTUPointDataset(root, DataConfig()), 1)
