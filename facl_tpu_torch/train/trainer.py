"""Contrastive pretraining: the train step, the eval step and the epoch
loop (counterpart of facl_tpu/train/trainer.py:35-347).

One step: points (G, B, N, C) crop-major -> batch-major (B, G, ...) ->
grouping (routed by ``GroupingConfig.select_impl`` / ``gather_impl``,
resolved once at build time as facl_tpu/train/trainer.py:83-87 does:
kernel B1 by default, B4 or B5a on the split routes, ops/grouping.py;
channel-major (B, C, S, K) neighbourhoods for the pair/pair3 SA stage,
channels-last (B, S, K, C) for the other impls) -> encoder (the SA stage
of ``ModelConfig.sa_impl``: pair3 by default, kernels B2/B3; pair
B2/B3/B6; hybrid2 B7/B8; hybrid B8; pallas B9; reference, covar and
analytic plain) -> global-local + circle InfoNCE -> backward -> Adam ->
LR schedule. The BatchNorm running statistics update during the forward,
which reads only batch statistics, so the order against Adam does not
change any value.

``compute_dtype`` "bfloat16" (every shipped training config) runs with
every ``sa_impl``: pair3 or pair (the bf16 sweeps of B2/B3 and B6),
hybrid2 (B7 and B8 at bf16), hybrid (B8 at bf16), pallas (B9 at bf16),
reference, covar, analytic, or auto (which resolves to pair3 or
reference): the SA stage, stage-2 MLP and head compute in bf16;
parameters, Adam state, losses and BatchNorm statistics stay f32
(models/pointnet.py).

Data parallelism (``mesh``, facl_tpu/train/trainer.py:90-229 on a dp
mesh): every rank groups and encodes its own block of the batch (grouping
is row-independent), with BatchNorm statistics over every rank's rows;
``gather_negatives`` builds the global embeddings in rank order, every
rank computes the global loss (the same value on each), and the
gradients are summed over the ranks, but for those the pair/pair3 and
analytic stages already return global (B6s). The circle loss's
permutation is rank 0's. Under ``mp > 1`` (tensor parallelism) the ranks
of an mp block run the same step on the same rows, each with its column
block of the wide Denses (models/layers.py::ColumnDense); every batch
collective and the gradient sum run over the dp group, so each gradient
is summed once per dp block, and the loss is the same on every rank.

``TrainConfig.split_step`` runs JAX's step as two programs to halve one
program's scratch arena, with identical math (trainer.py:96-108). Eager
torch has no program to split: the step is the same one, and a mesh with
more than one rank raises ValueError, as JAX does (:110-113).

SwAV (``use_swav``) and CLD (``use_cld``) follow trainer.py:152-180: the
SwAV loss, weighted by ``swav_weight``, over the crop-major code and
normalised embeddings, with its queue on ``TrainState.swav_queue``; CLD
added unweighted. The queue scores only from ``swav_queue_start_epoch``
on and once its last slot holds an embedding, and it is replaced by the
shifted queue only from that epoch. Under a mesh ``code`` and ``x_nor``
are gathered like ``x``, and every rank runs Sinkhorn, k-means and the
queue shift on the same global arrays (GSPMD's placement), so the queue
stays equal on every rank.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Union

import torch

from facl_tpu_torch import resolve_device
from facl_tpu_torch.config import Config, GroupingConfig
from facl_tpu_torch.losses import circle_infonce, cld_loss, \
    global_local_infonce, swav_loss, swav_queue_init
from facl_tpu_torch.models.layers import kernel_of
from facl_tpu_torch.models.pointnet import resolve_grouping, \
    resolve_model, resolve_model_config
from facl_tpu_torch.ops.grouping import group_points, \
    resolve_gather_impl, resolve_select_impl
from facl_tpu_torch.train.optim import make_optimizer
from facl_tpu_torch.parallel.collectives import broadcast, \
    gather_negatives, psum_grads
from facl_tpu_torch.models.sa_stage import check_impl_on_mesh
from facl_tpu_torch.parallel.mesh import Mesh, joined
from facl_tpu_torch.train.state import TrainState


def _reject_unported(cfg: Config, mesh: Optional[Mesh] = None) -> None:
    """Raise before any data moves for what no mesh runs: ``split_step``
    on more than one rank (as JAX, trainer.py:110-113), an SA impl
    without a sharded form (``check_impl_on_mesh``)."""
    if cfg.train.split_step and mesh is not None and \
            mesh.dp * mesh.mp > 1:
        raise ValueError("split_step targets single-device large-batch "
                         "runs; use the fused step under a mesh")
    check_impl_on_mesh(resolve_model_config(cfg.model).sa_impl, mesh)


def make_grouping_fn(g_cfg: GroupingConfig, layout: str = "bcsk"
                     ) -> Callable:
    """Grouping over a 4-D batch (A0, A1, N, C) of clouds -> neighbourhoods
    (A0, A1, ...) and centers (A0, A1, S, 3), on the route of
    ``g_cfg.select_impl`` / ``gather_impl``, resolved here once."""
    si, gi = resolve_select_impl(g_cfg), resolve_gather_impl(g_cfg)

    def group4d(points4d: torch.Tensor):
        A0, A1, N, C = points4d.shape
        neigh, cent = group_points(
            points4d.reshape(A0 * A1, N, C), g_cfg.num_centroids,
            g_cfg.knn_k, g_cfg.radius_sq, layout, g_cfg.method, si, gi)
        return (neigh.reshape(A0, A1, *neigh.shape[1:]),
                cent.reshape(A0, A1, -1, 3))
    return group4d


def make_train_step(cfg: Config, grouping: Optional[GroupingConfig] = None,
                    device: Union[str, torch.device] = "cuda",
                    mesh: Optional[Mesh] = None) -> Callable:
    """step(state, points, perm=None, generator=None, epoch=0) ->
    (state, metrics).

    points: (G, B, N, C) crop-major batch (moved to ``device``); with a
    ``mesh``, this rank's block of the global batch (``batch_slice``) and
    ``state.model`` built on the same mesh. perm: the circle loss's crop
    permutation (G,); drawn with ``generator`` when not given (rank 0's
    under a mesh). epoch: drives the SwAV queue gate. Metrics are
    detached 0-d tensors on the device, the global loss under a mesh."""
    device = resolve_device(device)
    _reject_unported(cfg, mesh)
    g_cfg = grouping or cfg.grouping
    l_cfg = cfg.loss
    layout = "bcsk" if resolve_model_config(cfg.model).channels_first \
        else "bskc"
    grouping_fn = make_grouping_fn(g_cfg, layout)

    def step(state: TrainState, points: torch.Tensor,
             perm: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None, epoch: int = 0):
        G, B, N, C = points.shape
        points = points.to(device, torch.float32)
        with torch.no_grad():
            neigh5, cent4 = grouping_fn(points.transpose(0, 1))
        neigh = neigh5.reshape(B * G, *neigh5.shape[2:])
        cent = cent4.reshape(B * G, *cent4.shape[2:])
        model = state.model
        model.train()
        x, code, x_nor, x_global = model(neigh, cent)
        # The global batch in rank order, this rank's block differentiable.
        x = gather_negatives(x, mesh)
        x_global = gather_negatives(x_global, mesh)
        B = x_global.shape[0]
        xg = x.reshape(B, G, -1).transpose(0, 1)               # (G, B, D)
        loss = torch.zeros((), device=device)
        metrics: Dict[str, torch.Tensor] = {}
        if l_cfg.use_global:
            lc = global_local_infonce(xg, x_global)
            metrics["loss_global"] = lc.detach()
            loss = loss + lc
        if l_cfg.use_circle:
            if perm is None:
                perm = torch.randperm(G, generator=generator)
            if joined(mesh):
                perm = broadcast(perm.to(device, copy=True), mesh)
            lcir = circle_infonce(xg, perm)
            metrics["loss_circle"] = lcir.detach()
            loss = loss + lcir
        if l_cfg.use_swav or l_cfg.use_cld:
            xn_g = gather_negatives(x_nor, mesh).reshape(B, G, -1) \
                .transpose(0, 1)                                # (G, B, D)
        if l_cfg.use_swav:
            code_g = gather_negatives(code, mesh).reshape(B, G, -1) \
                .transpose(0, 1)                                # (G, B, P)
            queue = state.swav_queue
            started = epoch >= l_cfg.swav_queue_start_epoch
            queue_on = started and queue is not None
            if queue_on:        # a 0-d tensor: no sync with the host
                queue_on = (queue[:, -1, :].abs() > 0).any()
            lswa, new_queue = swav_loss(
                code_g, xn_g, kernel_of(model.mapping), queue, queue_on,
                l_cfg.swav_temp_code, l_cfg.swav_temp_pred,
                l_cfg.swav_sinkhorn_iters)
            if started and new_queue is not None:
                state.swav_queue = new_queue
            metrics["loss_swav"] = lswa.detach()
            loss = loss + l_cfg.swav_weight * lswa
        if l_cfg.use_cld:
            lcld = cld_loss(xn_g, l_cfg.cld_temp, l_cfg.cld_clusters,
                            l_cfg.cld_kmeans_iters)
            metrics["loss_cld"] = lcld.detach()
            loss = loss + lcld
        metrics["loss"] = loss.detach()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        psum_grads(model.local_grad_params(), mesh)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return state, metrics

    return step


def make_eval_step(model: torch.nn.Module, cfg: Config,
                   grouping: Optional[GroupingConfig] = None) -> Callable:
    """Extraction step (facl_tpu/train/trainer.py:232-264): points
    (G, B, N, C) -> (x (B*G, D) batch-major, x_global (B, D)), f32, on
    the device of ``model``'s parameters, with its BatchNorm running
    statistics (eval mode, under ``torch.inference_mode``).

    Grouping runs on the route ``make_grouping_fn`` resolves, in the
    layout of the MODEL's resolved config (``PointNetPlus.cfg``): the JAX
    package records that deriving it from a pre-resolution config fed the
    encoder transposed neighbourhoods (trainer.py:241-249)."""
    g_cfg = grouping or cfg.grouping
    layout = "bcsk" if model.cfg.channels_first else "bskc"
    grouping_fn = make_grouping_fn(g_cfg, layout)
    device = next(model.parameters()).device

    def eval_step(points: torch.Tensor):
        G, B = points.shape[:2]
        model.eval()
        with torch.inference_mode():
            points = points.to(device, torch.float32)
            neigh5, cent4 = grouping_fn(points.transpose(0, 1))
            x, _, _, x_global = model(
                neigh5.reshape(B * G, *neigh5.shape[2:]),
                cent4.reshape(B * G, *cent4.shape[2:]))
        return x, x_global

    return eval_step


class Trainer:
    """Build the model, optimizer and step for ``cfg``; run epochs. With
    a ``mesh`` the model and step are data parallel (module docstring);
    each batch is then this rank's block."""

    def __init__(self, cfg: Config, steps_per_epoch: int,
                 device: Union[str, torch.device] = "cuda",
                 mesh: Optional[Mesh] = None):
        self.device = resolve_device(device)
        _reject_unported(cfg, mesh)
        self.cfg = cfg.replace(model=resolve_model_config(cfg.model))
        self.steps_per_epoch = steps_per_epoch
        self.mesh = mesh
        self.g_cfg = resolve_grouping(self.cfg)
        self.step_fn = make_train_step(self.cfg, self.g_cfg, self.device,
                                       mesh)

    def init_state(self, seed: Union[int, torch.Generator] = 0
                   ) -> TrainState:
        """Fresh parameters from ``seed`` (made on the CPU, so the same
        seed gives the same weights on every device), Adam and the LR
        schedule at update 0, and the zero SwAV queue when SwAV is on
        (length ``batch_size * swav_queue_factor`` of the global batch)."""
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator().manual_seed(int(seed))
        model, _ = resolve_model(self.cfg, gen, self.mesh)
        model = model.to(self.device)
        opt, sched = make_optimizer(model.parameters(), self.cfg.train.optim,
                                    self.steps_per_epoch)
        queue = None
        if self.cfg.loss.use_swav:
            # The global batch's queue: every rank holds all of it.
            queue = swav_queue_init(
                self.cfg.model.num_crops, self.cfg.train.batch_size *
                self.cfg.loss.swav_queue_factor, self.cfg.model.embed_dim,
                self.device)
        return TrainState(model, opt, sched, 0, queue)

    def run_epoch(self, state: TrainState, batches: Iterable[torch.Tensor],
                  epoch: int, generator: Optional[torch.Generator] = None,
                  log_fn: Optional[Callable[[Dict], None]] = None):
        """Run one epoch; returns (state, mean metrics + clips_per_sec).
        Metrics stay on the device until the end of the epoch (one sync),
        except for the periodic log line."""
        device_metrics = []
        clips = 0
        t0 = time.perf_counter()
        dp = self.mesh.dp if self.mesh is not None else 1
        for i, points in enumerate(batches):
            state, metrics = self.step_fn(state, points, generator=generator,
                                          epoch=epoch)
            clips += points.shape[1] * dp
            device_metrics.append(metrics)
            if log_fn is not None and i % self.cfg.train.log_every_steps == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=state.step, epoch=epoch)
                log_fn(m)
        out = {k: float(torch.stack([m[k] for m in device_metrics]).mean())
               for k in (device_metrics[0] if device_metrics else {})}
        dt = time.perf_counter() - t0
        out["clips_per_sec"] = clips / dt if dt > 0 else 0.0
        return state, out
