"""PKU-MMD cross-dataset transfer dataset (a copy of
facl_tpu/data/pku_mmd.py).

Re-derivation of ``PKU_MMD`` (linear_classify/dataset_of_lin.py:178-305):
a feature-based probe dataset for transfer evaluation — features extracted
by an NTU-pretrained encoder on PKU-MMD clips, split cross-view by the
camera letter in the file name (train cameras {R, M}; the letter sits at
position 7 and the action id in the last two digits before the extension).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

TRAIN_CAMERAS_PKU = ("R", "M")


@dataclass(frozen=True)
class PKUVideoInfo:
    name: str
    camera: str
    action: int          # 1-based

    @property
    def label(self) -> int:
        return self.action - 1


def parse_pku_name(fname: str) -> PKUVideoInfo:
    """Camera letter at character index 7, action = last two digits before
    the extension — e.g. ``0291-02R_A05.npy`` -> camera R, action 5
    (dataset_of_lin.py:264-272: ``vid_name[7:8]`` / ``vid_name[-6:-4]``)."""
    stem = fname[:-4] if fname.endswith(".npy") else fname
    camera = fname[7:8]
    action = int(stem[-2:])
    return PKUVideoInfo(stem, camera, action)


class PKUMMDFeatures:
    """Index + loader for per-video PKU-MMD feature files."""

    def __init__(self, root: str, train: bool = True,
                 train_cameras: Sequence[str] = TRAIN_CAMERAS_PKU):
        names = sorted(n for n in os.listdir(root) if n.endswith(".npy"))
        self.root = root
        self.infos: List[PKUVideoInfo] = [parse_pku_name(n) for n in names]
        self.files = names
        sel = [i for i, v in enumerate(self.infos)
               if (v.camera in train_cameras) == train]
        self.indices = sel

    def __len__(self) -> int:
        return len(self.indices)

    def load_all(self) -> Tuple[np.ndarray, np.ndarray]:
        feats, labels = [], []
        for i in self.indices:
            feats.append(np.load(os.path.join(self.root, self.files[i]))
                         .astype(np.float32).reshape(-1))
            labels.append(self.infos[i].label)
        return np.stack(feats), np.asarray(labels, np.int32)
