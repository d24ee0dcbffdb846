"""MoCo pretraining (counterpart of facl_tpu/train/moco_trainer.py).

One step: two views (2, B, N, C) of the same videos -> grouping of both
in one call over 2B clouds (kernel B1 once; channel-major for pair/pair3)
-> the key encoder, moved towards the query encoder's parameters as they
were before Adam (``momentum_update``), encodes view 1 in eval mode with
the query's BatchNorm statistics as they were before the step
(facl_tpu/train/moco_trainer.py:75-81) -> the query encoder encodes view 0
in train mode (the SA stage of ``sa_impl``: pair3's B2/B3 sweeps on the
card) -> [pos | queue] InfoNCE -> backward -> Adam -> LR schedule -> the
keys enter the ring queue.

The encoder is ``PointNetPlus`` with ``num_crops=1``: each call sees one
view a video, and only the per-crop embedding feeds the loss. The key
encoder is a second module of the same structure, without a mesh (its
eval forward runs no collective), whose running statistics are a copy of
the query's taken each step; only its parameters are an EMA.

Data parallelism (``mesh``, facl_tpu/train/moco_trainer.py:13-19): each
rank groups and encodes its block of the views, with global BatchNorm
statistics (pair3: B6s); the queries are gathered differentiably and the
keys without a gradient, in rank order, which is the global batch order
because the loader's blocks are contiguous. Every rank then computes the
global logits, the global loss (the mean over the global batch) and the
same enqueue of the global keys, so the queue and its pointer stay equal
on every rank; the gradients are summed over the ranks but for the pair
stage's, which come back global. Under ``mp > 1`` the query's wide
Denses hold their column blocks; the EMA reads the query's full kernels
(gathered over the mp ranks, ``full_parameters``), so the key encoder,
whole on every rank, is the same on each.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch

from facl_tpu_torch import resolve_device
from facl_tpu_torch.config import Config
from facl_tpu_torch.losses.infonce import cross_entropy
from facl_tpu_torch.models.layers import full_parameters
from facl_tpu_torch.models.moco import MoCoState, enqueue, init_moco_state, \
    moco_logits, momentum_update
from facl_tpu_torch.models.pointnet import PointNetPlus, resolve_model_config
from facl_tpu_torch.models.sa_stage import check_impl_on_mesh
from facl_tpu_torch.parallel.collectives import all_gather, \
    gather_negatives, psum_grads
from facl_tpu_torch.parallel.mesh import Mesh, shard_train_state
from facl_tpu_torch.train.optim import make_optimizer
from facl_tpu_torch.train.state import TrainState
from facl_tpu_torch.train.trainer import make_grouping_fn


@dataclass
class MoCoTrainState(TrainState):
    """The query encoder's TrainState and the MoCo state (key encoder,
    queue, pointer)."""
    moco: Optional[MoCoState] = None


def make_moco_step(cfg: Config, momentum: float = 0.9,
                   temperature: float = 1.0,
                   device: Union[str, torch.device] = "cuda",
                   mesh: Optional[Mesh] = None) -> Callable:
    """step(state, views) -> (state, metrics). views: (2, B, N, C), query
    and key crops of the same videos (this rank's block under a mesh),
    moved to ``device``; ``cfg.model`` resolved. Metrics: the global loss
    as a detached 0-d tensor on the device."""
    device = resolve_device(device)
    layout = "bcsk" if cfg.model.channels_first else "bskc"
    grouping_fn = make_grouping_fn(cfg.grouping, layout)

    def step(state: MoCoTrainState, views: torch.Tensor):
        model, ms = state.model, state.moco
        key = ms.key_encoder
        views = views.to(device, torch.float32)
        with torch.no_grad():
            neigh2, cent2 = grouping_fn(views)
            for kb, qb in zip(key.buffers(), model.buffers()):
                kb.copy_(qb)
            momentum_update(full_parameters(model), key.parameters(),
                            momentum)
            k = key(neigh2[1], cent2[1])[0]
        model.train()
        q = model(neigh2[0], cent2[0])[0]
        q = gather_negatives(q, mesh)
        k = all_gather(k, mesh)
        logits, labels = moco_logits(q, k, ms.queue, temperature)
        loss = cross_entropy(logits, labels)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        psum_grads(model.local_grad_params(), mesh)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        enqueue(ms, k)
        return state, {"loss": loss.detach()}

    return step


def shard_moco_state(mesh: Optional[Mesh], state: MoCoTrainState
                     ) -> MoCoTrainState:
    """Every rank takes rank 0's query and key encoders, Adam state and
    queue (``shard_train_state``); the pointer and the schedule are host
    values, alike on every rank. Returns ``state``."""
    key = state.moco.key_encoder
    return shard_train_state(mesh, state, extra=[
        *key.parameters(), *key.buffers(), state.moco.queue])


class MoCoTrainer:
    """Build the query encoder, its optimizer and the MoCo step for
    ``cfg`` (facl_tpu/train/moco_trainer.py:122-168). With a ``mesh`` the
    step is data parallel (module docstring); each batch of views is
    then this rank's block of the global batch."""

    def __init__(self, cfg: Config, steps_per_epoch: int,
                 queue_len: int = 9600, momentum: float = 0.9,
                 temperature: float = 1.0,
                 device: Union[str, torch.device] = "cuda",
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        model_cfg = resolve_model_config(
            dataclasses.replace(cfg.model, num_crops=1))
        check_impl_on_mesh(model_cfg.sa_impl, mesh)
        self.cfg = cfg.replace(model=model_cfg)
        self.steps_per_epoch = steps_per_epoch
        self.queue_len = queue_len
        self.mesh = mesh
        self.step_fn = make_moco_step(self.cfg, momentum, temperature,
                                      device=self.device, mesh=mesh)

    def init_state(self, seed: Union[int, torch.Generator] = 0,
                   batch: Optional[int] = None) -> MoCoTrainState:
        """Fresh query parameters from ``seed`` (on the CPU), the key
        encoder a copy of them, Adam and the schedule at update 0, and the
        queue drawn from the same generator, its length a multiple of the
        global ``batch`` (``cfg.train.batch_size`` when not given)."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator().manual_seed(int(seed))
        m_cfg = self.cfg.model
        model = PointNetPlus(m_cfg, gen, self.mesh).to(self.device)
        # The key's initial values are the query's (init_moco_state):
        # its own draws are thrown away.
        key = PointNetPlus(m_cfg, torch.Generator().manual_seed(0))
        opt, sched = make_optimizer(model.parameters(), self.cfg.train.optim,
                                    self.steps_per_epoch)
        batch = batch or self.cfg.train.batch_size
        # A multiple of the batch, at least one (moco_trainer.py:158-161).
        qlen = max((self.queue_len // batch) * batch, batch)
        mstate = init_moco_state(model, key, m_cfg.embed_dim, qlen, gen)
        return MoCoTrainState(model, opt, sched, 0, None, mstate)
