"""NTU-60/120 video-name parsing and evaluation splits (a copy of
facl_tpu/data/ntu.py: the port imports nothing of the JAX package).

One copy of the logic the reference keeps in three places
(cn3D_data_set.py:808-843, :964-993, dataset_of_lin.py:138-173), without
the pandas dependency.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Sequence, Tuple

# cn3D_data_set.py:25-34
TRAIN_IDS_60 = [1, 2, 4, 5, 8, 9, 13, 14, 15, 16, 17, 18, 19, 25, 27, 28,
                31, 34, 35, 38]
TRAIN_IDS_120 = TRAIN_IDS_60 + [45, 46, 47, 49, 50, 52, 53, 54, 55, 56, 57,
                                58, 59, 70, 74, 78, 80, 81, 82, 83, 84, 85,
                                86, 89, 91, 92, 93, 94, 95, 97, 98, 100, 103]
TRAIN_VALID_IDS = ([1, 2, 5, 8, 9, 13, 14, 15, 16, 18, 19, 27, 28, 31, 34,
                    38], [4, 17, 25, 35])
TRAIN_CAMERAS = [2, 3]                       # cn3D_data_set.py:821
TRAIN_SETUPS = list(range(2, 33, 2))         # even setups (:34)

_NAME_RE = re.compile(r".*S(\d{3})C(\d{3})P(\d{3})R(\d{3})A(\d{3}).*")


@dataclass(frozen=True)
class VideoInfo:
    name: str          # canonical 20-char S###C###P###R###A### prefix
    setup: int
    camera: int
    performer: int
    replication: int
    action: int        # 1-based

    @property
    def label(self) -> int:
        return self.action - 1


def parse_name(name: str) -> VideoInfo:
    m = _NAME_RE.match(name)
    if not m:
        raise ValueError(f"not an NTU video name: {name!r}")
    s, c, p, r, a = map(int, m.groups())
    canonical = f"S{s:03d}C{c:03d}P{p:03d}R{r:03d}A{a:03d}"
    return VideoInfo(canonical, s, c, p, r, a)


def is_ntu60(info: VideoInfo) -> bool:
    return info.setup <= 17 and info.action <= 60


def split_videos(
    infos: Sequence[VideoInfo],
    protocol: str = "xview",
    dataset: str = "ntu60",
) -> Tuple[List[int], List[int]]:
    """Return (train_indices, test_indices) under a protocol:
      xsub  — performer split (cn3D_data_set.py:824-831)
      xview — camera split, train cameras {2, 3} (:834-837)
      xset  — even/odd setup split (:840-843)
    """
    train_ids = TRAIN_IDS_60 if dataset == "ntu60" else TRAIN_IDS_120
    train, test = [], []
    for i, v in enumerate(infos):
        if protocol == "xsub":
            cond = v.performer in train_ids
        elif protocol == "xview":
            cond = v.camera in TRAIN_CAMERAS
        elif protocol == "xset":
            cond = v.setup in TRAIN_SETUPS
        else:
            raise ValueError(f"unknown protocol {protocol!r}")
        (train if cond else test).append(i)
    return train, test


def validation_split(infos: Sequence[VideoInfo]) -> Tuple[List[int], List[int]]:
    """Train-with-validation / validation performer split
    (cn3D_data_set.py:826-829)."""
    tr, va = [], []
    for i, v in enumerate(infos):
        if v.performer in TRAIN_VALID_IDS[0]:
            tr.append(i)
        elif v.performer in TRAIN_VALID_IDS[1]:
            va.append(i)
    return tr, va
