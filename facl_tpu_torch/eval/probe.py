"""Linear-probe evaluation (counterpart of facl_tpu/eval/probe.py;
linear_classify/linercls.py + fc_model.py).

One Linear layer trained on the concatenated motion + appearance
features of each video (2 streams x 11 crops x 512 = 11,264-d); top-1
and top-5 accuracy. Features are keyed by video name.

Hyper-parameters as linercls.py: Adam(5e-3, betas (0.5, 0.999), eps
1e-6; eps outside the square root, as optax's), StepLR(5, 0.7) indexed by
epoch (JAX scales the Adam update, facl_tpu/eval/probe.py:81-84, which is
the same as scaling the learning rate), 50 epochs, batches in the order
of one ``np.random.default_rng(1)`` permutation per epoch, evaluation
after epoch 15 and at the last epoch.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from facl_tpu_torch import resolve_device
from facl_tpu_torch.config import ProbeConfig
from facl_tpu_torch.models.probe import LinearProbe


def topk_accuracy(logits: np.ndarray, labels: np.ndarray,
                  ks: Sequence[int] = (1, 5)) -> List[float]:
    """Percentage top-k accuracies (linercls.py:158-172)."""
    order = np.argsort(-logits, axis=1)
    out = []
    for k in ks:
        hit = (order[:, :k] == labels[:, None]).any(axis=1)
        out.append(100.0 * hit.mean())
    return out


def combine_streams(motion: Dict[str, np.ndarray],
                    appearance: Dict[str, np.ndarray],
                    names: Sequence[str], labels: Sequence[int]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-video motion + appearance features, concatenated, for the
    videos that have both (dataset_of_lin.py:103-107 intent)."""
    feats, labs = [], []
    for n, l in zip(names, labels):
        if n in motion and n in appearance:
            feats.append(np.concatenate([motion[n], appearance[n]]))
            labs.append(l)
    return np.stack(feats), np.asarray(labs, np.int32)


class LinearProbeTrainer:
    def __init__(self, cfg: ProbeConfig, feature_dim: Optional[int] = None,
                 seed: int = 1, device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        dim = feature_dim or cfg.feature_dim * cfg.crops_per_stream * \
            cfg.num_streams
        self.model = LinearProbe(dim, cfg.num_classes,
                                 torch.Generator().manual_seed(seed)
                                 ).to(self.device)
        self.opt = torch.optim.Adam(self.model.parameters(),
                                    lr=cfg.learning_rate, betas=(0.5, 0.999),
                                    eps=1e-6)

    def lr(self, epoch: int) -> float:
        cfg = self.cfg
        return cfg.learning_rate * cfg.lr_decay_gamma ** (
            epoch // cfg.lr_decay_epochs)

    def fit(self, feats: np.ndarray, labels: np.ndarray,
            test_feats: Optional[np.ndarray] = None,
            test_labels: Optional[np.ndarray] = None,
            rng: Optional[np.random.Generator] = None,
            log_fn=None) -> Dict[str, float]:
        cfg = self.cfg
        rng = rng or np.random.default_rng(1)
        n = feats.shape[0]
        B = min(cfg.batch_size, n)
        x = torch.as_tensor(feats, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(labels, dtype=torch.int64, device=self.device)
        best = {"top1": -1.0, "top5": 0.0, "epoch": -1}
        self.model.train()
        for epoch in range(cfg.num_epochs):
            order = torch.as_tensor(rng.permutation(n), device=self.device)
            for group in self.opt.param_groups:
                group["lr"] = self.lr(epoch)
            for i in range(n // B):
                idx = order[i * B:(i + 1) * B]
                loss = F.cross_entropy(self.model(x[idx]), y[idx])
                self.opt.zero_grad(set_to_none=True)
                loss.backward()
                self.opt.step()
            # Reference gate: evaluate after epoch 15 (linercls.py:137),
            # and always at the last epoch so short runs report a score.
            if test_feats is not None and (epoch > cfg.eval_after_epoch
                                           or epoch == cfg.num_epochs - 1):
                top1, top5 = self.evaluate(test_feats, test_labels)
                if log_fn:
                    log_fn({"epoch": epoch, "loss": loss.item(),
                            "top1": top1, "top5": top5})
                if top1 > best["top1"]:
                    best = {"top1": top1, "top5": top5, "epoch": epoch}
        return best

    def evaluate(self, feats: np.ndarray, labels: np.ndarray
                 ) -> Tuple[float, float]:
        with torch.inference_mode():
            logits = self.model(torch.as_tensor(
                feats, dtype=torch.float32, device=self.device)).cpu().numpy()
        t1, t5 = topk_accuracy(logits, np.asarray(labels), (1, 5))
        return t1, t5
