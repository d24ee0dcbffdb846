"""Feature extraction: per-video 11 x 512 embedding dumps (counterpart of
facl_tpu/train/extract.py).

The trained encoder runs in eval mode over a split; per video the 10
per-crop embeddings, in crop order, are concatenated with the global
embedding (11 x 512 = 5632-d) and written as one .npy named by the video
(extract_{apperance,motion}_feature.py:34-221).

Under data parallelism (``mesh``, facl_tpu/cli/extract.py:45-80) each rank
runs the eval step on its block of each batch; the outputs are gathered
in rank order, the pad rows of a ragged batch dropped, and rank 0 writes
the files. Under tensor parallelism (``mp > 1``) the model's wide Denses
hold their column blocks (the eval step gathers their outputs over the
mp ranks) and the ranks of an mp block compute the same features; the
gather runs over the dp group.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from facl_tpu_torch.config import Config
from facl_tpu_torch.parallel.collectives import all_gather
from facl_tpu_torch.parallel.mesh import Mesh
from facl_tpu_torch.train.trainer import make_eval_step


def features_from_outputs(x: np.ndarray, x_global: np.ndarray,
                          num_crops: int) -> np.ndarray:
    """(B*G, D) batch-major + (B, D) -> (B, (G+1)*D): each video's crop
    embeddings in crop order, then its global embedding."""
    GB, D = x.shape
    B = GB // num_crops
    stacked = np.concatenate([x.reshape(B, num_crops, D), x_global[:, None]],
                             axis=1)
    return stacked.reshape(B, (num_crops + 1) * D)


def extract_features(model: torch.nn.Module, cfg: Config,
                     batches: Iterable[Tuple[torch.Tensor, np.ndarray,
                                             List[str]]],
                     out_dir: Optional[str] = None, grouping=None,
                     eval_step: Optional[Callable] = None,
                     mesh: Optional[Mesh] = None) -> Dict[str, np.ndarray]:
    """Run extraction over (crops (G, B, N, C), labels, names) batches
    (under a ``mesh``: this rank's crops, the true global batch's labels
    and names, as CropLoader yields them).

    Returns {video name: (11*D,) feature} (on every rank) and, with
    ``out_dir``, writes one .npy per video there (rank 0). ``grouping`` is
    the model's effective GroupingConfig; pass a prebuilt ``eval_step`` to
    reuse it."""
    if eval_step is None:
        eval_step = make_eval_step(model, cfg, grouping=grouping)
    G = cfg.model.num_crops
    feats: Dict[str, np.ndarray] = {}
    write = out_dir and (mesh is None or mesh.lead)
    if write:
        os.makedirs(out_dir, exist_ok=True)
    for crops, _, names in batches:
        x, x_global = eval_step(crops)
        x, x_global = all_gather(x, mesh), all_gather(x_global, mesh)
        f = features_from_outputs(x.cpu().numpy(), x_global.cpu().numpy(), G)
        for i, name in enumerate(names):
            feats[name] = f[i]
            if write:
                np.save(os.path.join(out_dir, name + ".npy"), f[i])
    return feats
