"""Contrastive pretraining entry point (counterpart of
facl_tpu/cli/pretrain.py; the reference's cn3d_train_{motion,apperance}_GL.py
as one script + ``--stream``).

Usage:
  python -m facl_tpu_torch.cli.pretrain --root <generated-tree> \
      --stream motion --epochs 100 --batch-size 64 --out checkpoints/motion

Data parallel, one process a card (``--batch-size`` is the global batch):
  torchrun --nproc_per_node 8 -m facl_tpu_torch.cli.pretrain --mesh \
      --config configs/multichip_ntu120.json --root <tree> --out <dir>

Tensor parallel too: a --config whose "mesh" sets "mp" (dp x mp ranks;
dp -1 takes the rest), e.g. {"mesh": {"dp": 4, "mp": 2}} on 8 ranks.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import time
from typing import Dict, List

import numpy as np
import torch

from facl_tpu_torch import resolve_device
from facl_tpu_torch.config import Config
from facl_tpu_torch.data import CropLoader, NTUPointDataset
from facl_tpu_torch.models.pointnet import SA_IMPLS
from facl_tpu_torch.parallel import finalize, initialize, make_mesh, \
    rank_device, shard_train_state
from facl_tpu_torch.train import SlowFastTrainer, Trainer, restore_latest, \
    save_checkpoint
from facl_tpu_torch.utils.logging import setup_logging


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--root", required=True, help="generated point-cloud tree")
    p.add_argument("--stream", choices=("motion", "appearance"),
                   default="motion")
    p.add_argument("--dataset", choices=("ntu60", "ntu120"), default="ntu60")
    p.add_argument("--protocol", choices=("xsub", "xview", "xset"),
                   default="xview")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16",
                   help="encoder compute dtype (parameters, Adam state and "
                        "BatchNorm statistics stay float32)")
    p.add_argument("--config", help="JSON config file overriding defaults")
    p.add_argument("--sa-impl", choices=SA_IMPLS, default=None,
                   help="SA-stage implementation (default: keep the config "
                        "value; 'auto' takes pair3, the B2/B3 kernels, where "
                        "they take the SA widths)")
    p.add_argument("--mesh", action="store_true",
                   help="data (and tensor) parallel over the ranks "
                        "torchrun starts (cfg.mesh: dp x mp ranks, dp -1 "
                        "for every rank mp leaves): each dp block of ranks "
                        "takes its block of every global batch, BatchNorm "
                        "statistics, negatives and gradients are global; "
                        "with mp > 1 the Denses of 512 columns or more are "
                        "split over the mp ranks. The batch size must "
                        "divide by dp.")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"),
                   default="nccl",
                   help="torch.distributed backend under --mesh: nccl (one "
                        "card a rank) or gloo (also several ranks a card, "
                        "or the CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda, the rank's card under "
                        "--mesh; raises without one)")


def build_config(args) -> Config:
    cfg = Config()
    if getattr(args, "config", None):
        with open(args.config) as f:
            cfg = Config.from_json(f.read())
    cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, root=args.root,
                                 stream=args.stream, dataset=args.dataset,
                                 protocol=args.protocol),
        train=dataclasses.replace(cfg.train, batch_size=args.batch_size),
    )
    if getattr(args, "dtype", None):
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, compute_dtype=args.dtype))
    if getattr(args, "sa_impl", None):
        # Forcing the impl re-opens channels_first to auto so the grouping
        # layout follows the chosen path.
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, sa_impl=args.sa_impl, channels_first=None))
    return cfg


def main(argv=None) -> List[Dict[str, float]]:
    """Returns each epoch's mean metrics (with ``clips_per_sec``)."""
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--out", default=None,
                   help="checkpoint dir (default: cfg.train.checkpoint_dir)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--resume", action="store_true")
    args = p.parse_args(argv)

    cfg = build_config(args)
    with mesh_of(args, cfg) as (mesh, device):
        return _pretrain(args, cfg, mesh, device)


@contextlib.contextmanager
def mesh_of(args, cfg: Config):
    """(mesh, device) of a CLI run: with ``--mesh`` this process joins the
    ranks' process group (``--dist-backend``; torchrun's environment) and
    runs on its rank's card, else (None, ``--device``). Logging is set
    up, at WARNING on the ranks but rank 0. Leaves the group it joined."""
    device = resolve_device(args.device)
    mesh, joined = None, False
    try:
        if args.mesh:
            joined = initialize(args.dist_backend)
            mesh = make_mesh(cfg.mesh)
            device = rank_device(device)
        setup_logging(logging.INFO if mesh is None or mesh.lead
                      else logging.WARNING)
        if mesh is not None:
            logging.getLogger("mesh").info(
                "mesh: dp=%d mp=%d backend=%s device=%s", mesh.dp, mesh.mp,
                args.dist_backend, device)
        yield mesh, device
    finally:
        if joined:
            finalize()


def _pretrain(args, cfg: Config, mesh, device) -> List[Dict[str, float]]:
    log = logging.getLogger("pretrain")
    if args.out is None:
        args.out = cfg.train.checkpoint_dir
    if mesh is not None and args.batch_size % mesh.dp:
        raise SystemExit(f"--mesh: batch size {args.batch_size} must divide "
                         f"by dp={mesh.dp}")

    ds = NTUPointDataset(args.root, cfg.data, train=True)
    if len(ds) < args.batch_size:
        raise SystemExit(
            f"pretrain: the train split has {len(ds)} video(s) — fewer "
            f"than --batch-size {args.batch_size} (batches are "
            "drop_last). Reduce --batch-size or generate more videos.")
    steps_per_epoch = max(1, len(ds) // args.batch_size)
    log.info("train videos=%d steps/epoch=%d device=%s", len(ds),
             steps_per_epoch, device)

    loader = CropLoader(ds, args.batch_size, seed=args.seed, device=device,
                        mesh=mesh)
    if cfg.model.name == "slow_fast":
        return _run_slowfast(args, cfg, loader, steps_per_epoch, mesh,
                             device)
    trainer = Trainer(cfg, steps_per_epoch, device=device, mesh=mesh)
    state = trainer.init_state(args.seed)
    start_epoch = 0
    if args.resume and restore_latest(args.out, state) is not None:
        start_epoch = state.step // steps_per_epoch
        log.info("resumed at epoch %d (step %d)", start_epoch, state.step)
    state = shard_train_state(mesh, state)

    history = []
    for epoch in range(start_epoch, args.epochs):
        batches = (b for b, _, _ in loader.epoch(epoch))
        # The circle loss's crop permutations: a stream of its own.
        gen = torch.Generator().manual_seed(int(np.random.SeedSequence(
            [args.seed, epoch], spawn_key=(1,)).generate_state(
                1, np.uint64)[0]))
        state, metrics = trainer.run_epoch(
            state, batches, epoch, generator=gen,
            log_fn=lambda m: log.info("%s", json.dumps(m)))
        history.append(metrics)
        log.info("epoch %d done: %s", epoch,
                 {k: round(v, 4) for k, v in metrics.items()})
        if epoch % cfg.train.checkpoint_every_epochs == 0:
            log.info("checkpoint %s", save_checkpoint(args.out, state, epoch,
                                                      mesh=mesh))
    save_checkpoint(args.out, state, args.epochs - 1, mesh=mesh)
    return history


def _run_slowfast(args, cfg: Config, loader, steps_per_epoch: int, mesh,
                  device) -> List[Dict[str, float]]:
    """Train the two-pathway encoder (``"name": "slow_fast"`` in
    --config; facl_tpu/cli/pretrain.py:153-184): each (G, B, N, C) crop
    batch (this rank's block under --mesh) is flattened to G*B single
    clouds, each one sample for both pathways. As in JAX, the run starts
    at epoch 0 (--resume is not read here)."""
    log = logging.getLogger("pretrain")
    if args.resume:
        log.warning("slow_fast: --resume is not supported; starting at "
                    "epoch 0")
    trainer = SlowFastTrainer(cfg, steps_per_epoch, device=device, mesh=mesh)
    state = shard_train_state(mesh, trainer.init_state(args.seed))
    history = []
    for epoch in range(args.epochs):
        losses, clips, t0 = [], 0, time.perf_counter()
        for batch, _, _ in loader.epoch(epoch):
            G, B, N, C = batch.shape
            state, m = trainer.step_fn(state, batch.reshape(G * B, N, C))
            losses.append(m["loss"])
            clips += B * (mesh.dp if mesh is not None else 1)
        mean = float(torch.stack(losses).mean())
        dt = time.perf_counter() - t0
        history.append({"loss": mean, "clips_per_sec": clips / dt})
        log.info("slow_fast epoch %d done: loss=%.4f", epoch, mean)
        if epoch % cfg.train.checkpoint_every_epochs == 0:
            log.info("checkpoint %s", save_checkpoint(args.out, state, epoch,
                                                      mesh=mesh))
    save_checkpoint(args.out, state, args.epochs - 1, mesh=mesh)
    return history


if __name__ == "__main__":
    main()
