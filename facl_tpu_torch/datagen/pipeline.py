"""End-to-end 3DV generation: depth frames -> the raw, key and appearance
point sets of a clip, and the walk over the NTU tree
(counterpart of facl_tpu/datagen/pipeline.py:38-342; generate_NTU.main,
generate_NTU.py:77-264).

"Resolution60/30/10" differ by the temporal frame cap K = 60/30/10.
Randomness is keyed per video: the frame cap draws from
``random.Random(f"{seed}:{h}")`` with ``h = crc32(f"{tag}:{K}")``
(Python's stdlib, so the same frames as the JAX package), and the
in-clip draws from a CPU ``torch.Generator`` seeded from (seed, h), moved
to the device. A sharded run therefore writes the unsharded tree, any
``clip_batch`` writes the same tree, and the card draws what the CPU
draws.

The grids of the clips of a batch are built together (masking,
back-projection, rank pooling and denoising over a leading clip axis);
each clip's sampling then makes its own draws.
"""
from __future__ import annotations

import os
import random
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from facl_tpu_torch import resolve_device
from facl_tpu_torch.config import DatagenConfig
from facl_tpu_torch.datagen.depth import backproject, locate_motion, \
    mask_depth
from facl_tpu_torch.datagen.pointize import RandInt, appearance_frame, \
    apply_normalization, normalization_stats, voxels_to_points
from facl_tpu_torch.datagen.voxelize import denoise, rank_pool

KEYS = ("raw", "key", "app", "n_raw", "n_key")


def generator_randint(gen: torch.Generator,
                      device: Union[str, torch.device]) -> RandInt:
    """``randint(n, shape)`` drawing from the CPU generator ``gen`` and
    moving the draws to ``device``: the card gets the CPU's draws."""
    def randint(n: int, shape) -> torch.Tensor:
        return torch.randint(0, n, shape, generator=gen).to(device)
    return randint


def generate_clips(frames: torch.Tensor, n_frames: Sequence[int],
                   cfg: DatagenConfig, randints: Sequence[RandInt]
                   ) -> Dict[str, torch.Tensor]:
    """V clips -> their stored artifacts, each with a leading clip axis.

    frames: (V, F_max, H, W) f32 raw depth (unmasked), zero past each
    clip's ``n_frames``; ``randints``: each clip's draw function (module
    docstring of datagen/pointize.py), called raw, key, then each
    appearance frame in order.

    Returns raw (V, S, 3+M), key (V, S, 3+M) (normalised 3DV points of
    the raw and the motion-located grid), app (V, A, S, 4) (A frames
    spread evenly over the clip), n_raw, n_key (V,) candidate counts."""
    V, F, H, W = frames.shape
    dev = frames.device
    S, A = cfg.sample_num, cfg.num_appearance_frames
    masked = mask_depth(frames, cfg.boundary_seg)
    # Frame 0 diffs against itself (the reference seeds prev with it).
    prev = torch.cat([masked[:, :1], masked[:, :-1]], dim=1)
    motion = locate_motion(prev, masked, cfg.motion_low, cfg.motion_high)
    pts, valid = backproject(masked, cfg)                  # (V, F, HW, 3)
    kpts, kvalid = backproject(motion, cfg)
    n = torch.as_tensor(list(n_frames), device=dev)
    in_clip = (torch.arange(F, device=dev)[None, :] < n[:, None])[..., None]
    valid, kvalid = valid & in_clip, kvalid & in_clip
    # Bounding box of every valid full-depth point; an empty clip keeps
    # the origin at 0.
    big = torch.tensor(1e9, device=dev)
    mins = torch.where(valid[..., None], pts, big).amin(dim=(1, 2))
    maxs = torch.where(valid[..., None], pts, -big).amax(dim=(1, 2))
    origin = torch.where(mins > maxs, torch.zeros_like(mins), mins)
    di, dkey = rank_pool(pts, valid, kpts, kvalid, n, origin, cfg)
    dkey = denoise(dkey, cfg.denoise_key_threshold)
    di[:, 0] = denoise(di[:, 0], cfg.denoise_raw_threshold)

    fsel = ((torch.arange(A, device=dev)[None, :] * n[:, None]) // A
            ).clamp(0, F - 1)
    outs = []
    for v, randint in enumerate(randints):
        raw_pts, n_raw = voxels_to_points(randint, di[v], S)
        # Key voxels gate the selection; the motion values come from the
        # raw grid (generate_NTU.py:212-221).
        key_pts, n_key = voxels_to_points(randint, di[v], S,
                                          select_mask=dkey[v] != 0)
        centers, y_len, c_min, c_len = normalization_stats(raw_pts)
        app = torch.stack([
            appearance_frame(randint, pts[v, fi], valid[v, fi], origin[v],
                             cfg.voxel_size, di[v, 0], S)
            for fi in fsel[v].tolist()])
        # Shared normalisation: xyz by the raw cloud's centers / y_len,
        # the motion channel by its channel-0 min-max (:258-260).
        app_xyz = (app[..., :3] - centers[None, None, :]) / y_len
        app_m = (app[..., 3] - c_min[0]) / c_len[0] - 0.5
        outs.append({
            "raw": apply_normalization(raw_pts, centers, y_len, c_min,
                                       c_len),
            "key": apply_normalization(key_pts, centers, y_len, c_min,
                                       c_len),
            "app": torch.cat([app_xyz, app_m[..., None]], dim=-1),
            "n_raw": n_raw, "n_key": n_key})
    return {k: torch.stack([o[k] for o in outs]) for k in KEYS}


def generate_clip(frames: torch.Tensor, n_frame: int, cfg: DatagenConfig,
                  randint: RandInt) -> Dict[str, torch.Tensor]:
    """One clip (F_max, H, W) -> raw (S, 3+M), key (S, 3+M),
    app (A, S, 4), n_raw, n_key (0-d): :func:`generate_clips` of one."""
    out = generate_clips(frames[None], [n_frame], cfg, [randint])
    return {k: v[0] for k, v in out.items()}


def _seed_of(seed: int, h: int) -> int:
    return int(np.random.SeedSequence([seed, h]).generate_state(
        1, np.uint64)[0])


class ClipGenerator:
    """Load-side wrapper for one resolution (frame cap): cap the frames,
    pad them into a (K, H, W) buffer, run the pipeline on ``device``.

    With a ``tag`` (the video's name) every draw derives from (seed, tag);
    without one the frame cap and the in-clip draws come from this
    generator's own sequential streams."""

    def __init__(self, cfg: DatagenConfig, max_frames: Optional[int] = None,
                 seed: int = 0, device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.max_frames = int(max_frames or cfg.max_frames)
        self.device = resolve_device(device)
        self._seed = seed
        self._py_rng = random.Random(seed)
        self._gen = torch.Generator().manual_seed(seed)

    def prepare(self, frames: np.ndarray, tag: Optional[str]
                ) -> Tuple[np.ndarray, int, RandInt]:
        """(the (K, H, W) f32 buffer, the frame count, the clip's draw
        function) of one clip's (F, H, W) raw frames."""
        F = frames.shape[0]
        K = self.max_frames
        if tag is None:
            py_rng, gen = self._py_rng, self._gen
        else:
            h = zlib.crc32(f"{tag}:{K}".encode())
            py_rng = random.Random(f"{self._seed}:{h}")
            gen = torch.Generator().manual_seed(_seed_of(self._seed, h))
        if F > K:
            frames = frames[sorted(py_rng.sample(range(F), K))]
            F = K
        H, W = self.cfg.image_shape
        buf = np.zeros((K, H, W), np.float32)
        buf[:F, :frames.shape[1], :frames.shape[2]] = \
            frames[:, :H, :W].astype(np.float32)
        return buf, F, generator_randint(gen, self.device)

    def from_frames(self, frames: np.ndarray, tag: Optional[str] = None
                    ) -> Dict[str, np.ndarray]:
        """frames: (F, H, W) uint16 or float raw depth (unmasked)."""
        return self.from_frames_batch([frames], [tag])[0]

    def from_frames_batch(self, frames_list: Sequence[np.ndarray],
                          tags: Optional[Sequence[Optional[str]]] = None
                          ) -> List[Dict[str, np.ndarray]]:
        """V clips through one :func:`generate_clips` call: the artifacts
        of V ``from_frames`` calls with the same tags."""
        tags = list(tags) if tags is not None else [None] * len(frames_list)
        preps = [self.prepare(f, t) for f, t in zip(frames_list, tags)]
        bufs = torch.from_numpy(np.stack([p[0] for p in preps]))
        out = generate_clips(bufs.to(self.device), [p[1] for p in preps],
                             self.cfg, [p[2] for p in preps])
        host = {k: v.cpu().numpy() for k, v in out.items()}
        return [{k: host[k][i] for k in host} for i in range(len(preps))]

    def from_dir(self, png_dir: str, tag: Optional[str] = None
                 ) -> Dict[str, np.ndarray]:
        return self.from_frames(load_png_frames(png_dir), tag=tag)


def load_png_frames(png_dir: str) -> np.ndarray:
    """Every depth PNG of one video directory, stacked (F, H, W) in name
    order. Needs ``imageio``."""
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise RuntimeError(
            "reading NTU depth PNGs needs the imageio package, which is "
            "not installed; generate from frames in memory "
            "(ClipGenerator.from_frames) or --synthetic instead") from e
    names = sorted(os.listdir(png_dir))
    return np.stack([np.asarray(imageio.imread(os.path.join(png_dir, n)))
                     for n in names])


def write_clip(res_dir: str, video: str, out: Dict[str, np.ndarray]) -> None:
    """One clip's files in the reference's layout (generate_NTU.py:
    86-112): raw/<video>.npy, others/<video>_key.npy, app/<video>_app.npy."""
    np.save(os.path.join(res_dir, "raw", video + ".npy"), out["raw"])
    np.save(os.path.join(res_dir, "others", video + "_key.npy"), out["key"])
    np.save(os.path.join(res_dir, "app", video + "_app.npy"), out["app"])


def generate_dataset(data_path: str, out_root: str, cfg: DatagenConfig,
                     seed: int = 0, limit: Optional[int] = None,
                     shard: int = 0, num_shards: int = 1,
                     clip_batch: int = 1,
                     device: Union[str, torch.device] = "cuda") -> int:
    """Walk <data_path>/<setup>/nturgb+d_depth_masked/<video>/ and write,
    per resolution, <out_root>/Resolution{K}/{raw,others,app}/. Returns
    the number of clips written.

    ``shard``/``num_shards``: only the videos whose index in the walk
    (counted on over the resolutions, as the JAX package counts) is
    ``shard`` mod ``num_shards``. ``clip_batch`` clips run through one
    :func:`generate_clips` call; the tree is the same for any value.
    ``limit`` stops after that many clips, counting every resolution."""
    if not (0 <= shard < num_shards):
        raise ValueError(f"shard {shard} out of range for {num_shards}")
    written = vid_idx = 0
    setups = sorted(os.listdir(data_path))
    for res in cfg.resolutions:
        gen = ClipGenerator(cfg, max_frames=res, seed=seed, device=device)
        res_dir = os.path.join(out_root, f"Resolution{res}")
        for sub in ("raw", "others", "app"):
            os.makedirs(os.path.join(res_dir, sub), exist_ok=True)

        def flush(group) -> int:
            if not group:
                return 0
            videos, dirs = zip(*group)
            outs = gen.from_frames_batch([load_png_frames(d) for d in dirs],
                                         tags=list(videos))
            for video, out in zip(videos, outs):
                write_clip(res_dir, video, out)
            return len(videos)

        group: List[Tuple[str, str]] = []
        for setup in setups:
            vid_root = os.path.join(data_path, setup, "nturgb+d_depth_masked")
            if not os.path.isdir(vid_root):
                continue
            for video in sorted(os.listdir(vid_root)):
                vid_idx += 1
                if (vid_idx - 1) % num_shards != shard:
                    continue
                if limit and written + len(group) >= limit:
                    break
                group.append((video, os.path.join(vid_root, video)))
                if len(group) >= max(1, clip_batch):
                    written += flush(group)
                    group = []
        written += flush(group)
        if limit and written >= limit:
            return written
    return written
