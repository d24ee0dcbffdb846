"""File-backed NTU dataset and crop loader (counterpart of
facl_tpu/data/dataset.py).

The host only reads .npy files; the 10-crop factory runs on the device,
seeded per batch, so an epoch's crops follow from (seed, epoch).

Directory layout (written by the JAX package's generator,
facl_tpu/data/dataset.py:12-17):
  <root>/Resolution60/raw/<video>.npy         (2048, 3+5) motion points
  <root>/Resolution60/others/<video>_key.npy  (2048, 3+5) key points
  <root>/Resolution60/app/<video>_app.npy     (A, 2048, 4) appearance sets
  <root>/Resolution{30,10}/...                lower temporal resolutions

Streams: motion crops from the raw clouds; appearance from the per-frame
appearance sets flattened into one (A * 2048, 4) pool, with the temporal
views still taken from the raw 3DV cloud.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from facl_tpu_torch import resolve_device
from facl_tpu_torch.config import DataConfig
from facl_tpu_torch.data import native
from facl_tpu_torch.data.crops import ClipSources, make_crops_batch
from facl_tpu_torch.data.ntu import VideoInfo, parse_name, split_videos, \
    validation_split
from facl_tpu_torch.ops.transforms import BatchRows
from facl_tpu_torch.parallel.mesh import Mesh, batch_slice, distributed

#: The five source files of a video, in ClipSources order.
KINDS = ("points", "key_points", "temporal_source", "res30", "res10")


class NTUPointDataset:
    """Index of generated clips + per-batch source loading."""

    def __init__(self, root: str, cfg: DataConfig, train: bool = True,
                 protocol: Optional[str] = None, split: Optional[str] = None):
        """``split`` overrides ``train`` when given: one of "train",
        "test", "validation", "train_with_validation"
        (cn3D_data_set.py:73-92)."""
        self.root = root
        self.cfg = cfg
        self.stream = cfg.stream
        raw_dir = os.path.join(root, "Resolution60", "raw")
        names = sorted(n[:-4] for n in os.listdir(raw_dir)
                       if n.endswith(".npy"))
        if cfg.dataset == "ntu60":
            names = [n for n in names if parse_name(n).action <= 60
                     and parse_name(n).setup <= 17]
        self.infos: List[VideoInfo] = [parse_name(n) for n in names]
        self.names = names
        split = split or ("train" if train else "test")
        if split in ("validation", "train_with_validation"):
            twv, val = validation_split(self.infos)
            self.indices = twv if split == "train_with_validation" else val
        else:
            tr, te = split_videos(self.infos, protocol or cfg.protocol,
                                  cfg.dataset)
            self.indices = tr if split == "train" else te
        self._shapes: Optional[Tuple[Tuple[int, ...], ...]] = None

    def __len__(self) -> int:
        return len(self.indices)

    def paths(self, name: str) -> Tuple[str, ...]:
        """The five source files of video ``name``, in ``KINDS`` order."""
        r = self.root
        if self.stream == "motion":
            sub, suffix = "raw", ".npy"
        else:
            sub, suffix = "app", "_app.npy"
        return (os.path.join(r, "Resolution60", sub, name + suffix),
                os.path.join(r, "Resolution60", "others", name + "_key.npy"),
                os.path.join(r, "Resolution60", "raw", name + ".npy"),
                os.path.join(r, "Resolution30", sub, name + suffix),
                os.path.join(r, "Resolution10", sub, name + suffix))

    def file_shapes(self) -> Tuple[Tuple[int, ...], ...]:
        """Each kind's stored array shape, read from the first video's
        .npy headers (every video of a tree has the same shapes)."""
        if self._shapes is None:
            self._shapes = tuple(
                np.load(p, mmap_mode="r").shape       # the header only
                for p in self.paths(self.names[self.indices[0]]))
        return self._shapes

    def _batch_meta(self, idxs: Sequence[int]):
        vids = [self.indices[i] for i in idxs]
        names = [self.names[v] for v in vids]
        labels = np.asarray([self.infos[v].label for v in vids], np.int32)
        return names, labels

    @staticmethod
    def _pool(t: torch.Tensor) -> torch.Tensor:
        """(B, A, S, 4) appearance sets -> one (B, A*S, 4) pool per video."""
        return t.reshape(t.shape[0], -1, t.shape[-1]) if t.ndim == 4 else t

    def load_sources(self, idx: int) -> Tuple[ClipSources, int, str]:
        """One video's source clouds (unbatched). Returns (sources, label,
        name)."""
        srcs, labels, names = self.load_batch_numpy([idx])
        return ClipSources(*(f[0] for f in srcs)), int(labels[0]), names[0]

    def load_batch(self, idxs: Sequence[int], pin: bool = False
                   ) -> Tuple[ClipSources, np.ndarray, List[str]]:
        """Stacked sources (CPU float32 tensors, in pinned memory with
        ``pin``), labels (B,) int32 and names of videos ``idxs``: through
        the native loader where it builds, else NumPy."""
        if native.native_available():
            return self.load_batch_native(idxs, pin)
        return self.load_batch_numpy(idxs, pin)

    def load_batch_numpy(self, idxs: Sequence[int], pin: bool = False
                         ) -> Tuple[ClipSources, np.ndarray, List[str]]:
        names, labels = self._batch_meta(idxs)
        per_video = [self.paths(n) for n in names]
        fields = []
        for k in range(len(KINDS)):
            t = torch.from_numpy(np.stack(
                [np.load(p[k]).astype(np.float32) for p in per_video]))
            fields.append(self._pool(t.pin_memory() if pin else t))
        return ClipSources(*fields), labels, names

    def load_batch_native(self, idxs: Sequence[int], pin: bool = False
                          ) -> Tuple[ClipSources, np.ndarray, List[str]]:
        """One parallel native load per kind (native/npy_loader.cc) of
        all the batch's files, straight into the stacked (pinned) buffer:
        no per-file NumPy arrays and no stacking copy."""
        names, labels = self._batch_meta(idxs)
        per_video = [self.paths(n) for n in names]
        fields = []
        for k, shape in enumerate(self.file_shapes()):
            out = torch.empty((len(names), *shape), dtype=torch.float32,
                              pin_memory=pin)
            native.load_into([p[k] for p in per_video], out)
            fields.append(self._pool(out))
        return ClipSources(*fields), labels, names


def batch_seed(seed: int, epoch: int, batch: int) -> int:
    """The crop generator's seed of batch ``batch`` of epoch ``epoch``."""
    return int(np.random.SeedSequence([seed, epoch, batch])
               .generate_state(1, np.uint64)[0])


class CropLoader:
    """Iterate (10, B, N, 4) crop batches on ``device``: a host thread
    prefetches the .npy sources (into pinned memory for a CUDA device),
    the main thread copies them to the device (``non_blocking``) and runs
    the crop factory there with a generator seeded from (seed, epoch,
    batch index). ``shuffle``/``drop_last`` as the torch DataLoader of
    cn3d_train_apperance_GL.py:171; ``shuffle=False`` yields the videos
    in the dataset's order, as the JAX loader does.

    With a data-parallel ``mesh`` every rank walks the same global
    batches (the same shuffle) and reads and crops only its block
    (``batch_slice``). A batch shorter than the mesh needs (a tail with
    ``drop_last=False``, or a batch size that does not divide over dp) is
    padded to ``ceil(batch_size / dp) * dp`` videos by repeating its first
    (facl_tpu/data/dataset.py:243-257); labels and names stay the true
    global batch's, so pad rows are computed and dropped. Each video's
    crops are those one process draws for it (``transforms.BatchRows``:
    the draws of the true batch, sliced to the rank's rows; a pad row takes
    its first video's), so the ranks' crops differ, and the run is the one
    process's run."""

    def __init__(self, dataset: NTUPointDataset, batch_size: int,
                 seed: int = 1, shuffle: bool = True, drop_last: bool = True,
                 prefetch: int = 2,
                 device: Union[str, torch.device] = "cuda",
                 mesh: Optional[Mesh] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self.mesh = mesh if distributed(mesh) else None

    def _block(self, n: int) -> List[int]:
        """Positions in a true batch of ``n`` videos of this rank's rows,
        after padding with the first video to the mesh's batch."""
        dp = self.mesh.dp
        target = -(-self.batch_size // dp) * dp
        padded = list(range(n)) + [0] * (target - n)
        return padded[batch_slice(self.mesh, target)]

    def batch_indices(self, epoch: int) -> List[List[int]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng([self.seed, epoch]).shuffle(order)
        B = self.batch_size
        nb = len(order) // B if self.drop_last else -(-len(order) // B)
        return [order[i * B:(i + 1) * B].tolist() for i in range(nb)]

    def epoch(self, epoch_idx: int
              ) -> Iterator[Tuple[torch.Tensor, np.ndarray, List[str]]]:
        """Yield (crops (10, B, N, 4) on the device, labels (B,), names)."""
        batches = self.batch_indices(epoch_idx)
        pin = self.device.type == "cuda"
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer():
            # Host reads (and pinning) only: every CUDA copy and kernel is
            # issued by the main thread, on its current stream.
            try:
                for idxs in batches:
                    if self.mesh is not None:
                        idxs = [idxs[j] for j in self._block(len(idxs))]
                    if not put(("batch", self.ds.load_batch(idxs, pin))):
                        return
                put(("end", None))
            except Exception as e:        # handed to the main thread
                put(("error", e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            for i in range(len(batches) + 1):
                kind, item = q.get()
                if kind == "error":
                    raise item
                if kind == "end":
                    break
                srcs, labels, names = item
                srcs = ClipSources(*(f.to(self.device, non_blocking=True)
                                     for f in srcs))
                g = torch.Generator(device=self.device)
                g.manual_seed(batch_seed(self.seed, epoch_idx, i))
                if self.mesh is not None:
                    true = batches[i]
                    names, labels = self.ds._batch_meta(true)
                    g = BatchRows(g, len(true), torch.tensor(
                        self._block(len(true)), device=self.device))
                yield make_crops_batch(g, srcs, self.ds.cfg), labels, names
        finally:
            stop.set()
            t.join(timeout=60)
