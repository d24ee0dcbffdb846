"""Slow/fast encoder training (counterpart of
facl_tpu/train/slowfast_trainer.py).

One step: clouds (B, N, C) -> grouped twice (kernel B1 twice, channels
last), with K = min(slow_k, N) for the slow branch and min(fast_k, N) for
the fast one -> ``PointNetSlowFast`` in train mode -> the 2-view pair
InfoNCE between the two pathways' embeddings -> backward -> Adam -> LR
schedule.

Data parallelism (``mesh``; the JAX trainer gets it from GSPMD): each rank
groups and encodes its block of the clouds with global BatchNorm
statistics; both embeddings are gathered in rank order
(``gather_negatives``) and every rank computes the loss over the global
arrays, as the main trainer does; the gradients are summed over the ranks.
The gathered rows are a permutation of the one-process rows (the pretrain
CLI flattens each rank's (G, B/dp) block), and the pair InfoNCE's mean
cross-entropy does not change under a permutation applied to both views.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch

from facl_tpu_torch import resolve_device
from facl_tpu_torch.config import Config
from facl_tpu_torch.losses.infonce import cross_entropy, pair_infonce
from facl_tpu_torch.models.slowfast import PointNetSlowFast
from facl_tpu_torch.ops.grouping import group_points, resolve_gather_impl, \
    resolve_select_impl
from facl_tpu_torch.parallel.collectives import gather_negatives, psum_grads
from facl_tpu_torch.parallel.mesh import Mesh
from facl_tpu_torch.train.optim import make_optimizer
from facl_tpu_torch.train.state import TrainState


@dataclass
class SlowFastTrainState(TrainState):
    """A TrainState whose model is ``PointNetSlowFast`` (no SwAV queue)."""


def make_slowfast_step(cfg: Config, slow_k: int = 128, fast_k: int = 64,
                       device: Union[str, torch.device] = "cuda",
                       mesh: Optional[Mesh] = None) -> Callable:
    """step(state, points) -> (state, metrics). points: (B, N, C) clouds
    (this rank's under a mesh), moved to ``device``. Metrics: the global
    loss as a detached 0-d tensor on the device."""
    device = resolve_device(device)
    g = cfg.grouping
    si, gi = resolve_select_impl(g), resolve_gather_impl(g)

    def group(points, k):
        return group_points(points, g.num_centroids, min(k, points.shape[1]),
                            g.radius_sq, layout="bskc", method=g.method,
                            select_impl=si, gather_impl=gi)[0]

    def step(state: SlowFastTrainState, points: torch.Tensor):
        points = points.to(device, torch.float32)
        with torch.no_grad():
            slow_n, fast_n = group(points, slow_k), group(points, fast_k)
        model = state.model
        model.train()
        x_fast, x_slow = model(slow_n, fast_n)
        x_fast = gather_negatives(x_fast, mesh)
        x_slow = gather_negatives(x_slow, mesh)
        logits, labels = pair_infonce(x_fast, x_slow,
                                      torch.cat([x_fast, x_slow]))
        loss = cross_entropy(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        psum_grads(model.parameters(), mesh)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return step


class SlowFastTrainer:
    """Build the two-pathway encoder, its optimizer and step for ``cfg``
    (facl_tpu/train/slowfast_trainer.py:80-104); data parallel with a
    ``mesh`` (module docstring)."""

    def __init__(self, cfg: Config, steps_per_epoch: int, slow_k: int = 128,
                 fast_k: int = 64, device: Union[str, torch.device] = "cuda",
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.steps_per_epoch = steps_per_epoch
        self.slow_k, self.fast_k = slow_k, fast_k
        self.mesh = mesh
        self.step_fn = make_slowfast_step(cfg, slow_k, fast_k, self.device,
                                          mesh)

    def init_state(self, seed: Union[int, torch.Generator] = 0
                   ) -> SlowFastTrainState:
        """Fresh parameters from ``seed`` (made on the CPU), Adam and the
        LR schedule at update 0."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator().manual_seed(int(seed))
        model = PointNetSlowFast(self.cfg.model, gen, self.mesh).to(
            self.device)
        opt, sched = make_optimizer(model.parameters(), self.cfg.train.optim,
                                    self.steps_per_epoch)
        return SlowFastTrainState(model, opt, sched, 0)
