"""Train state (counterpart of facl_tpu/train/state.py): the module (its
parameters and BatchNorm running statistics), the optimizer with its
moments, the LR scheduler, the global update count, and the SwAV queue
(``swav_queue``: (G-1, Q, D) f32 on the device, None when SwAV is off).
PyTorch updates these in place; the step function returns the same
object."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    step: int = 0
    swav_queue: Optional[torch.Tensor] = None
