"""Linear probe head (counterpart of facl_tpu/models/probe.py;
linear_classify/fc_model.py:12-25): L2-normalise the concatenated
per-video features, then one Linear to class logits, weight ~ N(0, 0.01)
and bias zero as in the reference."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from facl_tpu_torch.models.layers import l2_normalize


class LinearProbe(nn.Module):
    def __init__(self, in_features: int, num_classes: int = 120,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, num_classes)
        with torch.no_grad():
            self.Dense_0.weight.normal_(0.0, 0.01, generator=generator)
            self.Dense_0.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_0(l2_normalize(x, dim=1))
