"""Feature extraction entry point (counterpart of facl_tpu/cli/extract.py;
the reference's extract_{apperance,motion}_feature.py as one script +
``--stream``).

Usage:
  python -m facl_tpu_torch.cli.extract --root <tree> --stream motion \
      --checkpoint checkpoints/motion --out features/motion

With ``--mesh`` under torchrun each rank extracts its block of every batch
and rank 0 writes the features (the same files as one process writes);
with ``mp > 1`` in the config's mesh the wide Denses are split over the mp
ranks, as JAX's extraction places them (``param_sharding``).
"""
from __future__ import annotations

import argparse
import logging

import torch

from facl_tpu_torch.cli.pretrain import add_common_args, build_config, \
    mesh_of
from facl_tpu_torch.data import CropLoader, NTUPointDataset
from facl_tpu_torch.models.pointnet import resolve_model
from facl_tpu_torch.parallel.mesh import tensor_parallel
from facl_tpu_torch.train import Trainer, latest_checkpoint, \
    make_eval_step, restore_latest
from facl_tpu_torch.train.extract import extract_features


def main(argv=None) -> int:
    """Returns the number of feature files written."""
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)

    cfg = build_config(args)
    if latest_checkpoint(args.checkpoint) is None:
        raise SystemExit(f"no checkpoint found in {args.checkpoint!r} "
                         "(expected index.json written by pretrain)")
    with mesh_of(args, cfg) as (mesh, device):
        return _extract(args, cfg, mesh, device)


def _extract(args, cfg, mesh, device) -> int:
    log = logging.getLogger("extract")

    # Both splits in turn, unshuffled, every video (extract_apperance_
    # feature.py:112-136,163,192), through one Trainer, one restore and
    # one eval step. trainer.cfg, not cfg: the Trainer resolved sa_impl /
    # channels_first, and the eval step's layout must match the model's.
    trainer = Trainer(cfg, steps_per_epoch=1, device=device)
    state = trainer.init_state(args.seed)
    if tensor_parallel(mesh):
        # The encoder with its split Denses; its eval forward runs the mp
        # gathers and no batch collective. The restore loads the whole
        # file and each rank keeps its blocks (the optimizer, unused here,
        # keeps the whole model's).
        state.model = resolve_model(
            trainer.cfg, torch.Generator().manual_seed(args.seed),
            mesh)[0].to(device)
    restore_latest(args.checkpoint, state)
    eval_step = make_eval_step(state.model, trainer.cfg, trainer.g_cfg)
    written = 0
    for split, train in (("train", True), ("test", False)):
        ds = NTUPointDataset(args.root, cfg.data, train=train)
        if len(ds) == 0:
            log.warning("empty %s split", split)
            continue
        loader = CropLoader(ds, min(args.batch_size, len(ds)),
                            seed=args.seed, shuffle=False, drop_last=False,
                            device=device, mesh=mesh)
        feats = extract_features(state.model, trainer.cfg, loader.epoch(0),
                                 out_dir=args.out, eval_step=eval_step,
                                 mesh=mesh)
        written += len(feats)
        log.info("%s split: wrote %d feature files to %s", split,
                 len(feats), args.out)
    return written


if __name__ == "__main__":
    main()
