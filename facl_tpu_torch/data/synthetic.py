"""Synthetic data: depth clips and generated point-cloud trees for tests,
benchmarks and the end-to-end smoke path without the (license-gated) NTU
download (counterpart of facl_tpu/data/synthetic.py).

The depth clips are numpy, copied from the JAX package as they are, so a
seed gives the same clips bit for bit; the trees are generated by the
port's own ClipGenerator (facl_tpu_torch/datagen), on ``device``."""
from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import numpy as np
import torch

from facl_tpu_torch.config import DatagenConfig
from facl_tpu_torch.datagen import ClipGenerator
from facl_tpu_torch.datagen.pipeline import write_clip


def _bounce(p0: float, v: float, f: int, lo: int, hi: int) -> float:
    """Position at frame f of a particle reflecting between lo/hi.

    Class-conditioned clips use this instead of np.clip: a blob that
    CLIPS at the frame border freezes, produces no inter-frame motion,
    and the datagen pipelines then emit a DEGENERATE point cloud — the
    reference generator crashes outright (randint(0, 0),
    generate_NTU.py:225) and ours writes the all-constant fallback
    cloud. Identical all-zero clips are poison for the
    instance-discriminating InfoNCE objective: at ~10% of the train
    split, half the batches ask it to separate IDENTICAL inputs and
    the representation collapses to the uniform-logit floor — the
    actual root cause of the r5 504-video collapse (green 144-video
    runs had 5% empties in train by split-placement luck; BASELINE.md
    round-5 scale note)."""
    if hi <= lo:
        return float(lo)
    span = float(hi - lo)
    q = (p0 - lo + v * f) % (2.0 * span)
    return lo + (span - abs(q - span))


def _articulated_clip(rng: np.random.Generator, frames: np.ndarray,
                      action: int, num_actions: int) -> None:
    """One articulated 6-part figure with class-conditioned translation
    (see the v4 note in :func:`synthetic_depth_clip`). Parts are rigid
    relative to the figure — every interior inter-frame depth diff
    equals the class ddepth (edge-only motion regime preserved) — while
    the per-clip proportions, joint offsets, depth layers, surface
    textures and silhouettes give ~40 crop-stable instance DOF."""
    n_frames, H, W = frames.shape
    jrange = min(0.15, 0.5 * np.pi / max(num_actions, 1))
    ang = (2.0 * np.pi * (action - 1) / max(num_actions, 1)
           + float(rng.uniform(-jrange, jrange)))
    speed = (3.0 if action % 2 else 6.0) * float(rng.uniform(0.85, 1.15))
    vx, vy = speed * np.cos(ang), speed * np.sin(ang)
    ddepth = 25.0 * (1.0 if action % 2 else -1.0)
    depth = float(rng.uniform(1800, 3200))
    x0 = int(rng.integers(W // 4, max(W // 4 + 1, W // 2)))
    y0 = int(rng.integers(H // 4, max(H // 4 + 1, H // 2)))

    specs = [(0, 0, int(rng.integers(H // 5, H // 3)),
              int(rng.integers(W // 8, W // 5)))]          # torso
    for _ in range(5):                                     # limbs/head
        specs.append((int(rng.integers(-H // 5, H // 5 + 1)),
                      int(rng.integers(-W // 6, W // 6 + 1)),
                      int(rng.integers(H // 10, H // 3)),
                      int(rng.integers(W // 12, W // 5))))
    parts = []
    for k, (dy, dx, ph, pw) in enumerate(specs):
        dz = 0.0 if k == 0 else float(rng.uniform(-300, 300))
        yy, xx = np.mgrid[0:ph, 0:pw].astype(np.float32)
        uy, ux = yy - (ph - 1) / 2.0, xx - (pw - 1) / 2.0
        tex = (float(rng.uniform(-1.5, 1.5)) * ux
               + float(rng.uniform(-1.5, 1.5)) * uy
               + float(rng.uniform(-0.018, 0.018)) * (ux * ux + uy * uy))
        if rng.uniform() < 0.5:
            mask = ((uy / (ph / 2.0)) ** 2 + (ux / (pw / 2.0)) ** 2) <= 1.0
        else:
            mask = np.ones((ph, pw), bool)
        parts.append((dy, dx, ph, pw, dz, tex, mask))

    for f in range(n_frames):
        # The BASE trajectory bounces off margins (never freezes — see
        # _bounce); individual parts may still clip at the border for
        # a few frames, which only deforms the silhouette there.
        bx = _bounce(x0, vx, f, W // 6, W - W // 6)
        by = _bounce(y0, vy, f, H // 5, H - H // 5)
        for dy, dx, ph, pw, dz, tex, mask in parts:
            x = int(np.clip(bx + dx, 0, W - pw - 1))
            y = int(np.clip(by + dy, 0, H - ph - 1))
            patch = frames[f, y:y + ph, x:x + pw]
            vals = depth + dz + ddepth * f + tex
            # nearest-surface composition at part overlaps
            sel = mask & ((patch == 0) | (vals < patch))
            patch[sel] = vals[sel]


def synthetic_depth_clip(rng: np.random.Generator, n_frames: int = 16,
                         shape=(424, 512), n_blobs: int = 2,
                         action: Optional[int] = None,
                         num_actions: int = 5,
                         style: str = "instance") -> np.ndarray:
    """A human-ish synthetic depth sequence: moving rectangles at plausible
    Kinect depths (mm).

    ``action`` (1-based) makes the MOTION class-conditioned: the blob
    travels along a class-specific direction (angle 2*pi*(a-1)/A, with
    per-clip jitter) at a class-alternating speed, and its depth drifts
    with a class-dependent sign. The rank-pooled 3DV channels encode
    exactly such temporal structure, so clips of the same action are
    linearly separable in a well-trained embedding — this is what
    tools/train_synthetic_probe.py uses to demonstrate end-to-end
    unsupervised learning without the license-gated NTU data. With
    ``action=None`` the motion is unconditioned (smoke-test mode).

    ``style`` picks the depth-drift regime (r4 — the two uses pull in
    opposite directions):

    * ``"instance"`` (default; tools/train_synthetic_probe.py): |ddepth|
      stays BELOW the 50 mm motion-localisation threshold
      (datagen/depth.py::locate_motion), so motion registers only at the
      blob EDGES — sparse, per-clip-varied point sets that keep clips of
      one class distinguishable. This is the regime the r3 learning
      demonstration used; with interior-dense motion (below) the clips of
      a class become near-identical dense rectangles, the
      instance-discriminating InfoNCE objective collapses within ~1
      epoch, and the random-encoder probe control inflates
      (device-measured r4: control 71-80%, trained -> majority-class).
    * ``"reference_window"`` (write_synthetic_png_tree, the
      cross-framework e2e): |ddepth| INSIDE the (50, 300) window so the
      blob interior registers as motion every frame — required because
      the reference generator crashes on an empty key-voxel set
      (randint(0, 0), generate_NTU.py:224) and so cannot even represent
      the edge-only regime."""
    if style not in ("instance", "blobs", "reference_window"):
        raise ValueError(f"unknown style {style!r}")
    H, W = shape
    frames = np.zeros((n_frames, H, W), np.float32)
    if style == "instance" and action is not None:
        # v4 (r5): one ARTICULATED MULTI-PART FIGURE per clip instead of
        # independent rectangles. Scale study (BASELINE.md round-5 scale
        # note): with ~15 crop-stable DOF per clip, the instance-
        # discrimination objective collapses to the uniform-logit floor
        # within the first epoch once the train split exceeds ~150
        # clips — in facl_tpu AND bit-for-bit in the reference torch
        # pipeline on the same tree (tools/diag_torch_504.py). The
        # trajectories of the 144-green and 504-red runs are
        # statistically identical until clips start REPEATING (step ~6
        # at 144 vs ~19 at 504, batch 16): repetition anchors instance
        # codes; before it, fresh low-DOF clips make the in-batch
        # discrimination task degenerate. Real NTU depth clips are
        # near-unique per clip; this figure (6 parts x per-clip
        # proportions, offsets, depth layers, surface textures — ~40
        # DOF, all rigid so the edge-only motion regime is preserved)
        # is the toy analogue. Class semantics are UNCHANGED: the whole
        # figure translates with the class angle/speed and class-signed
        # depth drift.
        _articulated_clip(rng, frames, action, num_actions)
        return frames
    for b in range(n_blobs):
        h = int(rng.integers(H // 4, H // 2))
        w = int(rng.integers(W // 10, W // 5))
        depth = float(rng.uniform(*(
            (2500, 3500) if style == "reference_window" else (1500, 3500))))
        if action is None:
            y0 = int(rng.integers(0, H - h))
            vx = max(1, (W - w - 1) // max(n_frames, 1))
            vx = int(rng.integers(1, min(4, vx) + 1))
            x0 = int(rng.integers(0, max(1, W - w - n_frames * vx)))
            vy = 0.0
            ddepth = 80.0 if style == "reference_window" else 20.0
        else:
            # Angle jitter scales with the class spacing (r5): 1/4 of
            # the 2*pi/A wedge, capped at the historical +-0.15 rad —
            # identical to the green r3/r5 behavior for A <= 10, and
            # non-overlapping for the larger class counts the
            # clips-per-class scaling study uses (BASELINE.md round-5
            # scale note).
            jrange = min(0.15, 0.5 * np.pi / max(num_actions, 1))
            ang = (2.0 * np.pi * (action - 1) / max(num_actions, 1)
                   + float(rng.uniform(-jrange, jrange)))
            speed = (3.0 if action % 2 else 6.0) * float(
                rng.uniform(0.85, 1.15))
            vx = speed * np.cos(ang)
            vy = speed * np.sin(ang)
            x0 = int(rng.integers(W // 4, max(W // 4 + 1, W // 2)))
            y0 = int(rng.integers(H // 4, max(H // 4 + 1, H // 2)))
            # The class-conditioned motion magnitudes are FIXED per class
            # (sign by parity), not drawn per clip: the round-4 regression
            # (BASELINE.md round-5 root-cause note)
            # was caused by per-clip-random |ddepth| in [15, 40] and a
            # widened speed jitter — per-clip magnitudes are an INSTANCE
            # signature, and the instance-discriminating InfoNCE
            # objective uses exactly that nuisance to separate clips,
            # orthogonalizing class structure (all sa_impl x dtype x
            # platform arms landed at chance on that data;
            # tools/diag_collapse.py). Instance variation for the
            # contrastive task comes from blob size/position/base-depth
            # instead. reference_window keeps |ddepth| inside the
            # (50, 300) motion window per the style contract above.
            ddepth = ((150.0 if style == "reference_window" else 25.0)
                      * (1.0 if action % 2 else -1.0))
        # Per-blob GEOMETRY signature (instance style, r5): a depth
        # texture (tilt plane + dome) and an ellipse-vs-rectangle
        # silhouette that ride WITH the blob — crop-stable,
        # high-dimensional, class-orthogonal instance identity. At ~300
        # train clips the r5-fixed plain-rectangle clips left the
        # instance-discrimination task unsolvable from 512-point crops
        # (too few stable per-clip DOF) and the objective collapsed to
        # the uniform-logit floor — in facl_tpu AND bit-for-bit in the
        # reference torch pipeline on the same tree
        # (tools/diag_torch_504.py; BASELINE.md round-5 scale note).
        # The texture's temporal self-difference under blob motion
        # (|grad| * |v| <~ 20 mm) keeps interior inter-frame diffs
        # below the 50 mm motion-localisation threshold, preserving
        # the instance style's edge-only motion regime.
        if style == "instance" and action is not None:
            yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
            uy, ux = yy - (h - 1) / 2.0, xx - (w - 1) / 2.0
            # Amplitudes sized for the 60 mm datagen voxel grid (the
            # texture must survive voxel quantization, ~+-1-2 voxels
            # over a blob) under the edge-only constraint
            # |grad tex|*|v| + |ddepth| < 50 mm (worst case ~48).
            gx = float(rng.uniform(-1.5, 1.5))
            gy = float(rng.uniform(-1.5, 1.5))
            dome = float(rng.uniform(-0.018, 0.018))
            tex = gx * ux + gy * uy + dome * (ux * ux + uy * uy)
            if rng.uniform() < 0.5:
                mask = ((uy / (h / 2.0)) ** 2
                        + (ux / (w / 2.0)) ** 2) <= 1.0
            else:
                mask = np.ones((h, w), bool)
        else:
            tex = np.zeros((h, w), np.float32)
            mask = np.ones((h, w), bool)
        for f in range(n_frames):
            if action is not None:
                # Bounce, never freeze — frozen blobs mean degenerate
                # point clouds (see _bounce).
                x = int(_bounce(x0, vx, f, 0, W - w - 1))
                y = int(_bounce(y0, vy, f, 0, H - h - 1))
            else:
                x = int(np.clip(x0 + vx * f, 0, W - w - 1))
                y = int(np.clip(y0 + vy * f, 0, H - h - 1))
            patch = frames[f, y:y + h, x:x + w]
            patch[mask] = (depth + ddepth * f + tex)[mask]
    return frames


def synthetic_ntu_names(num: int, rng: np.random.Generator,
                        num_actions: int = 10) -> Sequence[str]:
    names = []
    for i in range(num):
        s = int(rng.integers(1, 5))
        c = int(rng.integers(1, 4))
        p = int(rng.integers(1, 20))
        r = int(rng.integers(1, 3))
        a = int(rng.integers(1, num_actions + 1))
        names.append(f"S{s:03d}C{c:03d}P{p:03d}R{r:03d}A{a:03d}")
    return names


def write_synthetic_png_tree(root: str, num_videos: int = 64, seed: int = 0,
                             n_frames: int = 16, shape=(424, 512),
                             class_conditioned: bool = True,
                             num_actions: int = 10) -> Sequence[str]:
    """Synthetic depth clips as 16-bit PNGs in the NTU on-disk layout
    (``<root>/<setup>/nturgb+d_depth_masked/<video>/<video>_fNNN.png``) —
    the INPUT both datagen pipelines consume (ours via
    ``cli.generate --data``; the reference's generate_NTU.py:96-121 walks
    the same layout), enabling a cross-framework end-to-end comparison
    from identical pixels.

    Frames are at the Kinect-native shape so the reference's border
    cropping (generate_NTU.py:339-351, boundary_seg 60/29/10/10) behaves
    as designed. Depth values are millimeters stored as uint16, exactly
    like NTU's masked depth maps."""
    import imageio.v2 as imageio

    rng = np.random.default_rng(seed)
    pool = sorted(set(synthetic_ntu_names(num_videos * 3, rng,
                                          num_actions=num_actions)))
    if len(pool) < num_videos:
        raise ValueError(f"could not draw {num_videos} unique names")
    names = pool[:num_videos]
    for i, name in enumerate(names):
        setup = name[:4].lower()           # sNNN chunk dir, like the real tree
        vdir = os.path.join(root, setup, "nturgb+d_depth_masked", name)
        os.makedirs(vdir, exist_ok=True)
        clip_rng = np.random.default_rng(seed * 1000 + i)
        action = int(name[-3:]) if class_conditioned else None
        # reference_window REQUIRED here: the PNG tree feeds the
        # reference generator, whose motion localisation only sees
        # |ddepth| inside the (50, 300) window (locate_motion,
        # generate_NTU.py:355-366) and crashes on an empty key-voxel
        # set otherwise (randint(0, 0), :225) — the instance style's
        # sub-50 mm drift is invisible to it (style contract in
        # synthetic_depth_clip's docstring).
        frames = synthetic_depth_clip(clip_rng, n_frames=n_frames,
                                      shape=shape, action=action,
                                      num_actions=num_actions,
                                      style="reference_window")
        for f in range(frames.shape[0]):
            imageio.imwrite(os.path.join(vdir, f"{name}_f{f:03d}.png"),
                            frames[f].astype(np.uint16))
    return names


def write_random_tree(root: str, num_videos: int = 128, seed: int = 0,
                      sample_num: int = 2048, app_frames: int = 10
                      ) -> Sequence[str]:
    """Random-VALUE tree in the generated on-disk layout (raw (N,8),
    key (N,8), app (A,N,4)) — for host-pipeline throughput benchmarking
    where datagen cost would dominate; values are plausible-scale
    (normalized coords ~[-1,1]) but meaningless. Use
    ``write_synthetic_dataset`` when the *content* matters."""
    rng = np.random.default_rng(seed)
    names = sorted(set(synthetic_ntu_names(num_videos * 4, rng)))
    if len(names) < num_videos:
        raise ValueError(f"could not draw {num_videos} unique names")
    names = names[:num_videos]
    for res in (60, 30, 10):
        res_dir = os.path.join(root, f"Resolution{res}")
        for sub in ("raw", "others", "app"):
            os.makedirs(os.path.join(res_dir, sub), exist_ok=True)
        for name in names:
            raw = (rng.standard_normal((sample_num, 8)) * 0.3
                   ).astype(np.float32)
            key = (rng.standard_normal((sample_num, 8)) * 0.3
                   ).astype(np.float32)
            app = (rng.standard_normal((app_frames, sample_num, 4)) * 0.3
                   ).astype(np.float32)
            np.save(os.path.join(res_dir, "raw", name + ".npy"), raw)
            np.save(os.path.join(res_dir, "others", name + "_key.npy"), key)
            np.save(os.path.join(res_dir, "app", name + "_app.npy"), app)
    return names


def write_synthetic_dataset(root: str, num_videos: int = 8, seed: int = 0,
                            datagen_cfg: Optional[DatagenConfig] = None,
                            class_conditioned: bool = False,
                            num_actions: int = 5,
                            clip_batch: int = 4,
                            style: str = "instance",
                            device: Union[str, torch.device] = "cuda"
                            ) -> Sequence[str]:
    """Generate a small synthetic point-cloud tree in the on-disk layout the
    dataset/loader expect, by running the *real* datagen pipeline on
    synthetic depth clips (cross-clip batched, ``clip_batch`` clips a
    call), on ``device``.

    ``class_conditioned``: give each clip the motion signature of its
    name's action id (see :func:`synthetic_depth_clip`) so an
    unsupervised-pretrained embedding has a linearly separable class
    structure to find — the basis of the end-to-end learning
    demonstration (tools/train_synthetic_probe.py)."""
    rng = np.random.default_rng(seed)
    # boundary_seg scaled to the toy image shape: the reference crop
    # (60, 29, 10, 10) is sized for 424x512 Kinect frames
    # (generate_NTU.py:339-351); applied verbatim to 128x160 frames it
    # wipes rows < 60 — half the image — and silently turns every
    # mostly-horizontal mover (class angles near 0/pi) into the
    # DEGENERATE all-constant point cloud. ~10% identical clips in a
    # train split is exactly the instance-discrimination poison that
    # caused the r5 504-video collapse (BASELINE.md round-5 scale
    # note; the reference torch pipeline collapses on such a tree too,
    # torch_collapse_504.json).
    cfg = datagen_cfg or DatagenConfig(
        grid_shape=(48, 48, 48), image_shape=(128, 160),
        sample_num=2048, num_appearance_frames=10,
        voxel_size=60.0, resolutions=(60, 30, 10),
        boundary_seg=(18, 9, 3, 3))
    pool = sorted(set(synthetic_ntu_names(num_videos * 3, rng,
                                          num_actions=num_actions)))
    if len(pool) < num_videos:
        raise ValueError(f"could not draw {num_videos} unique names")
    names = pool[:num_videos]
    for res in cfg.resolutions:
        gen = ClipGenerator(cfg, max_frames=res, seed=seed, device=device)
        res_dir = os.path.join(root, f"Resolution{res}")
        for sub in ("raw", "others", "app"):
            os.makedirs(os.path.join(res_dir, sub), exist_ok=True)
        for start in range(0, len(names), clip_batch):
            chunk = names[start:start + clip_batch]
            clips = []
            for i, name in enumerate(chunk):
                clip_rng = np.random.default_rng(seed * 1000 + start + i)
                action = (int(name[-3:])
                          if class_conditioned else None)
                clips.append(synthetic_depth_clip(
                    clip_rng, n_frames=min(16, res),
                    shape=cfg.image_shape, action=action,
                    num_actions=num_actions, style=style))
            outs = gen.from_frames_batch(clips, tags=list(chunk))
            for name, out in zip(chunk, outs):
                write_clip(res_dir, name, out)
    return names
