"""Structured logging + metrics helpers (a copy of
facl_tpu/utils/logging.py).

Replaces the reference's hard-coded-path ``logging.basicConfig``
(cn3d_train_apperance_GL.py:151-153) and its ``AverageMeter``
(linercls.py:174-195).
"""
from __future__ import annotations

import logging
import sys
from typing import Optional


def setup_logging(level: int = logging.INFO,
                  logfile: Optional[str] = None) -> None:
    handlers = [logging.StreamHandler(sys.stdout)]
    if logfile:
        handlers.append(logging.FileHandler(logfile))
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        datefmt="%Y/%m/%d %H:%M:%S",
        handlers=handlers,
        force=True,
    )


class AverageMeter:
    """Running average (linercls.py:174-195 semantics)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1) -> None:
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

    def __str__(self) -> str:
        return f"{self.name} {self.val:.4f} ({self.avg:.4f})"
