"""The port's checkpoints (facl_tpu_torch/train/checkpoint.py) on the
CPU: the full train state round-trips bit for bit; two steps equal one
step, a save, a restore into a fresh Trainer and one more step, bit for
bit, learning rate included; writes leave no temp file; pruning keeps
``keep`` files; ``index.json`` names the latest. The contract is
facl_tpu/train/checkpoint.py:24-81's."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from facl_tpu_torch.config import Config, GroupingConfig
from facl_tpu_torch.train import Trainer, latest_checkpoint, \
    restore_checkpoint, restore_latest, save_checkpoint

G, B, N = 4, 3, 48


def _trainer():
    cfg = Config()
    cfg = cfg.replace(
        model=dataclasses.replace(
            cfg.model, sa_widths=(8, 8, 16), stage2_widths=(16, 32),
            fc_hidden=24, embed_dim=12, num_prototypes=6, num_crops=G),
        grouping=GroupingConfig(num_centroids=8, knn_k=8, radius_sq=0.5),
        train=dataclasses.replace(
            cfg.train, batch_size=B,
            optim=dataclasses.replace(cfg.train.optim, lr_decay_epochs=1)))
    return Trainer(cfg, steps_per_epoch=1, device="cpu")


def _batches(rng, n):
    return [torch.from_numpy(rng.uniform(-0.6, 0.6, size=(G, B, N, 4))
                             .astype(np.float32)) for _ in range(n)]


PERM = torch.tensor([2, 0, 3, 1])


def _assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i in oa["state"]:
        for k, v in oa["state"][i].items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert a.scheduler.state_dict() == b.scheduler.state_dict()
    assert a.scheduler.get_last_lr() == b.scheduler.get_last_lr()
    assert a.step == b.step


def test_round_trip_is_bit_exact(rng, tmp_path):
    tr = _trainer()
    st = tr.init_state(0)
    for pts in _batches(rng, 2):
        st, _ = tr.step_fn(st, pts, perm=PERM)
    path = save_checkpoint(str(tmp_path), st, epoch=1)
    assert os.path.basename(path) == "ckpt_epoch_00001.pt"
    fresh = _trainer().init_state(5)
    assert restore_checkpoint(path, fresh) is fresh
    _assert_same_state(st, fresh)
    # BN running statistics and Adam moments are really in there.
    assert float(fresh.model.sa_stage.mean_0.abs().max()) > 0
    assert len(fresh.optimizer.state_dict()["state"]) == \
        sum(p.grad is not None for p in st.model.parameters()) > 20
    assert fresh.step == 2


def test_resume_equals_an_uninterrupted_run(rng, tmp_path):
    b1, b2 = _batches(rng, 2)
    tr = _trainer()
    full = tr.init_state(0)
    full, _ = tr.step_fn(full, b1, perm=PERM)
    full, m_full = tr.step_fn(full, b2, perm=PERM)

    part = tr.init_state(0)
    part, _ = tr.step_fn(part, b1, perm=PERM)
    save_checkpoint(str(tmp_path), part, epoch=0)
    tr2 = _trainer()
    resumed = restore_latest(str(tmp_path), tr2.init_state(9))
    # The schedule decays after every epoch of 1 step: the restored
    # learning rate is the decayed one.
    assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(
        3e-4 * 0.7)
    resumed, m_res = tr2.step_fn(resumed, b2, perm=PERM)
    assert torch.equal(m_res["loss"], m_full["loss"])
    _assert_same_state(full, resumed)
    assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(
        3e-4 * 0.49)


def test_files_index_and_pruning(rng, tmp_path, monkeypatch):
    tr = _trainer()
    st = tr.init_state(0)
    d = str(tmp_path / "ck")
    assert latest_checkpoint(d) is None and restore_latest(d, st) is None
    for epoch in range(5):
        save_checkpoint(d, st, epoch, keep=3)
    files = sorted(os.listdir(d))
    assert files == ["ckpt_epoch_00002.pt", "ckpt_epoch_00003.pt",
                     "ckpt_epoch_00004.pt", "index.json"]
    assert not any(f.endswith(".tmp") for f in files)
    with open(os.path.join(d, "index.json")) as f:
        assert json.load(f) == {"latest_epoch": 4,
                                "latest": "ckpt_epoch_00004.pt"}
    assert latest_checkpoint(d) == os.path.join(d, "ckpt_epoch_00004.pt")
    # The files hold tensors and plain containers only.
    saved = torch.load(latest_checkpoint(d), weights_only=True)
    assert set(saved) == {"model", "optimizer", "scheduler", "step"}
    # A write that fails midway leaves neither a temp file nor a changed
    # latest.
    def broken(obj, f):
        f.write(b"partial")
        raise OSError("disk full")
    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(d, st, 9)
    assert sorted(os.listdir(d)) == files
    assert latest_checkpoint(d).endswith("00004.pt")
