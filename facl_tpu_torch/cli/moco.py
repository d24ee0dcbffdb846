"""MoCo pretraining entry point (counterpart of facl_tpu/cli/moco.py):
a query encoder trained against a momentum key encoder over two-view
SimCLR crops, with a ring queue of negative keys.

Usage:
  python -m facl_tpu_torch.cli.moco --root <tree> --stream motion \
      --epochs 100 --batch-size 64 --out checkpoints/moco

Data parallel, one process a card (``--batch-size`` is the global batch):
  torchrun --nproc_per_node 8 -m facl_tpu_torch.cli.moco --mesh \
      --root <tree> --out <dir>
"""
from __future__ import annotations

import argparse
import logging
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from facl_tpu_torch.cli.pretrain import add_common_args, build_config, \
    mesh_of
from facl_tpu_torch.data import ClipSources, NTUPointDataset, \
    make_simclr_crops
from facl_tpu_torch.data.dataset import batch_seed
from facl_tpu_torch.models.pointnet import resolve_model_config
from facl_tpu_torch.parallel.mesh import Mesh, batch_slice, distributed
from facl_tpu_torch.train import MoCoTrainer, save_checkpoint, \
    shard_moco_state


def simclr_batches(ds: NTUPointDataset, batch_size: int, seed: int,
                   num_points: int, epoch: int, device="cpu",
                   mesh: Optional[Mesh] = None) -> Iterator[torch.Tensor]:
    """Yield (2, B, N, 4) two-view batches on ``device``: the videos
    shuffled by (seed, epoch), the tail dropped, each batch's views drawn
    by ``make_simclr_crops`` video by video from one generator seeded by
    (seed, epoch, batch) (``dataset.batch_seed``). Under a ``mesh`` each
    rank reads and crops the whole batch, so its draws are one process's,
    and yields its block (``batch_slice``) of axis 1."""
    order = np.random.default_rng([seed, epoch]).permutation(len(ds))
    for i in range(len(order) // batch_size):
        srcs, _, _ = ds.load_batch(order[i * batch_size:
                                         (i + 1) * batch_size].tolist())
        srcs = ClipSources(*(f.to(device) for f in srcs))
        g = torch.Generator(device=device)
        g.manual_seed(batch_seed(seed, epoch, i))
        views = torch.stack([make_simclr_crops(
            g, ClipSources(*(f[j] for f in srcs)), num_points)
            for j in range(batch_size)], dim=1)
        yield views[:, batch_slice(mesh, batch_size)] \
            if distributed(mesh) else views


def main(argv=None) -> List[Dict[str, float]]:
    """Returns each epoch's mean loss and clips/s."""
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--out", default="checkpoints/moco")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--queue-len", type=int, default=9600,
                   help="negative queue length (reference default)")
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--temperature", type=float, default=1.0)
    args = p.parse_args(argv)

    cfg = build_config(args)
    with mesh_of(args, cfg) as (mesh, device):
        return _moco(args, cfg, mesh, device)


def _moco(args, cfg, mesh, device) -> List[Dict[str, float]]:
    log = logging.getLogger("moco")
    ds = NTUPointDataset(args.root, cfg.data, train=True)
    if len(ds) == 0:
        raise SystemExit("moco: the train split is empty")
    steps_per_epoch = max(1, len(ds) // args.batch_size)
    log.info("train videos=%d steps/epoch=%d device=%s", len(ds),
             steps_per_epoch, device)
    # The EFFECTIVE batch (a small dataset caps it below --batch-size) is
    # what the ranks split and what the kernels see.
    batch = min(args.batch_size, len(ds))
    if mesh is not None:
        dp = mesh.dp
        if batch % dp:
            raise SystemExit(
                f"--mesh: effective batch size {batch} (min of "
                f"--batch-size and {len(ds)} train videos) must divide by "
                f"dp={dp}")
        if resolve_model_config(cfg.model).sa_impl in ("pair", "pair3") \
                and (batch // dp) % 2:
            # The paired-row SA kernels take rows two at a time, and MoCo
            # encodes one view a call: a rank's rows are batch/dp.
            raise SystemExit(
                f"--mesh: per-rank batch {batch}//{dp}={batch // dp} must "
                "be even for the paired-row SA kernels; pick a batch size "
                'divisible by 2*dp or set "sa_impl": "reference" in '
                "--config")

    trainer = MoCoTrainer(cfg, steps_per_epoch, queue_len=args.queue_len,
                          momentum=args.momentum,
                          temperature=args.temperature, device=device,
                          mesh=mesh)
    state = shard_moco_state(mesh, trainer.init_state(args.seed, batch))
    history = []
    for epoch in range(args.epochs):
        losses, t0 = [], time.perf_counter()
        for views in simclr_batches(ds, batch, args.seed,
                                    cfg.data.num_points, epoch, device,
                                    mesh):
            state, m = trainer.step_fn(state, views)
            losses.append(m["loss"])
        mean = float(torch.stack(losses).mean())
        dt = time.perf_counter() - t0
        history.append({"loss": mean,
                        "clips_per_sec": len(losses) * batch / dt})
        log.info("epoch %d done: loss=%.4f", epoch, mean)
        if epoch % cfg.train.checkpoint_every_epochs == 0:
            log.info("checkpoint %s", save_checkpoint(args.out, state, epoch,
                                                      mesh=mesh))
    save_checkpoint(args.out, state, args.epochs - 1, mesh=mesh)
    return history


if __name__ == "__main__":
    main()
