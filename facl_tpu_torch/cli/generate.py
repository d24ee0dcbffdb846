"""Offline 3DV generation entry point (counterpart of
facl_tpu/cli/generate.py; the reference's generate_data/generate_NTU.py).

Usage:
  python -m facl_tpu_torch.cli.generate --data <ntu120dataset> --out <tree>
  python -m facl_tpu_torch.cli.generate --synthetic 8 --out <tree>
"""
from __future__ import annotations

import argparse
import logging

from facl_tpu_torch import resolve_device
from facl_tpu_torch.config import DatagenConfig
from facl_tpu_torch.utils.logging import setup_logging


def main(argv=None) -> int:
    """Returns the number of videos (--synthetic) or clips written."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", help="NTU depth-masked root "
                   "(<root>/<setup>/nturgb+d_depth_masked/<video>/*.png)")
    p.add_argument("--out", required=True, help="output tree root")
    p.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic videos instead of reading NTU")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--clip-batch", type=int, default=4,
                   help="clips whose grids are built together (the output "
                   "tree is the same for any value)")
    p.add_argument("--shard", default="0/1",
                   help="i/n: process only every n-th video starting at i; "
                   "per-video randomness is keyed by (seed, video), so the "
                   "shards together write the unsharded tree")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without one)")
    args = p.parse_args(argv)
    try:
        shard_i, shard_n = (int(x) for x in args.shard.split("/"))
    except ValueError:
        p.error("--shard must be i/n (e.g. 0/4)")

    setup_logging()
    log = logging.getLogger("generate")
    device = resolve_device(args.device)
    if args.synthetic:
        from facl_tpu_torch.data.synthetic import write_synthetic_dataset
        names = write_synthetic_dataset(args.out, args.synthetic, args.seed,
                                        clip_batch=max(1, args.clip_batch),
                                        device=device)
        log.info("wrote %d synthetic videos to %s", len(names), args.out)
        return len(names)
    if not args.data:
        p.error("--data or --synthetic required")
    from facl_tpu_torch.datagen import generate_dataset
    n = generate_dataset(args.data, args.out, DatagenConfig(),
                         seed=args.seed, limit=args.limit or None,
                         shard=shard_i, num_shards=shard_n,
                         clip_batch=max(1, args.clip_batch), device=device)
    log.info("wrote %d clips to %s (shard %d/%d)", n, args.out, shard_i,
             shard_n)
    return n


if __name__ == "__main__":
    main()
