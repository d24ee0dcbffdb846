"""Linear-probe entry point (counterpart of facl_tpu/cli/probe.py; the
reference's linear_classify/linercls.py).

Usage:
  python -m facl_tpu_torch.cli.probe --root <tree> \
      --motion-features f/motion --appearance-features f/appearance \
      --dataset ntu60 --protocol xview
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import Dict

import numpy as np

from facl_tpu_torch.config import DataConfig, ProbeConfig
from facl_tpu_torch.data import NTUPointDataset, PKUMMDFeatures
from facl_tpu_torch.eval import LinearProbeTrainer, combine_streams
from facl_tpu_torch.utils.logging import setup_logging


def load_feature_dir(path: str) -> Dict[str, np.ndarray]:
    return {n[:-4]: np.load(os.path.join(path, n))
            for n in os.listdir(path) if n.endswith(".npy")}


def main(argv=None) -> Dict[str, float]:
    """Prints ``top1=...``; returns the best epoch's scores."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root")
    p.add_argument("--motion-features")
    p.add_argument("--appearance-features")
    p.add_argument("--pku",
                   help="PKU-MMD transfer evaluation: directory of per-video "
                        "feature .npy files extracted by an NTU-pretrained "
                        "encoder; cross-view split by camera letter "
                        "(dataset_of_lin.py:178-305). Replaces --root/"
                        "--*-features.")
    p.add_argument("--dataset", choices=("ntu60", "ntu120"),
                   default="ntu60")
    p.add_argument("--protocol", choices=("xsub", "xview", "xset"),
                   default="xview")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--num-classes", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without one)")
    args = p.parse_args(argv)

    setup_logging()
    log = logging.getLogger("probe")
    if args.pku:
        return _run_pku(args, log)
    if not (args.root and args.motion_features and args.appearance_features):
        p.error("--root, --motion-features and --appearance-features are "
                "required (or use --pku for transfer evaluation)")

    data_cfg = DataConfig(dataset=args.dataset, protocol=args.protocol)
    motion = load_feature_dir(args.motion_features)
    appearance = load_feature_dir(args.appearance_features)
    num_classes = args.num_classes or (60 if args.dataset == "ntu60" else 120)
    pcfg = ProbeConfig(num_classes=num_classes, num_epochs=args.epochs)

    splits = {}
    for split, train in (("train", True), ("test", False)):
        ds = NTUPointDataset(args.root, data_cfg, train=train)
        names = [ds.names[i] for i in ds.indices]
        labels = [ds.infos[i].label for i in ds.indices]
        splits[split] = combine_streams(motion, appearance, names, labels)
        log.info("%s: %d videos with both streams", split,
                 len(splits[split][0]))

    trainer = LinearProbeTrainer(pcfg, splits["train"][0].shape[1],
                                 device=args.device)
    best = trainer.fit(*splits["train"], *splits["test"],
                       log_fn=lambda m: log.info("%s", m))
    log.info("best top-1: %.2f%% (top-5 %.2f%%, epoch %d)",
             best["top1"], best["top5"], best["epoch"])
    print(f"top1={best['top1']:.2f}")
    return best


def _run_pku(args, log) -> Dict[str, float]:
    """Cross-dataset transfer: the probe on PKU-MMD features from an
    NTU-pretrained encoder (dataset_of_lin.py:178-305: one feature dir,
    cross-view split by camera letter; 51 PKU-MMD action classes)."""
    train_ds = PKUMMDFeatures(args.pku, train=True)
    test_ds = PKUMMDFeatures(args.pku, train=False)
    if len(train_ds) == 0 or len(test_ds) == 0:
        raise SystemExit(f"--pku dir {args.pku!r} has an empty split "
                         f"(train={len(train_ds)}, test={len(test_ds)})")
    tr_f, tr_y = train_ds.load_all()
    te_f, te_y = test_ds.load_all()
    log.info("pku transfer: train=%d test=%d dim=%d", len(tr_y), len(te_y),
             tr_f.shape[1])
    pcfg = ProbeConfig(num_classes=args.num_classes or 51,
                       num_epochs=args.epochs)
    trainer = LinearProbeTrainer(pcfg, tr_f.shape[1], device=args.device)
    best = trainer.fit(tr_f, tr_y, te_f, te_y,
                       log_fn=lambda m: log.info("%s", m))
    log.info("pku best top-1: %.2f%% (top-5 %.2f%%, epoch %d)",
             best["top1"], best["top5"], best["epoch"])
    print(f"top1={best['top1']:.2f}")
    return best


if __name__ == "__main__":
    main()
