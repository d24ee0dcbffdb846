"""The port's CLIs under data parallelism on the CPU: ``pretrain --mesh
--dist-backend gloo --device cpu`` on two ranks (each through main() in
a rank the launcher starts), one epoch, then ``--resume`` to two, on the
tiny tree the JAX generator writes (tests/test_torch_cli.py's); then
``extract --mesh`` with a batch that does not divide over the ranks (the
loader pads it), and the same extraction under ``torchrun``. Rank 0
writes the checkpoints and the features; each video's features equal the
one-process extraction's from the same checkpoint at 1e-5 of their scale.
Each rank crops its videos as one process does (data/dataset.py::
CropLoader), so the two-rank run is the one-process run: its first epoch
takes the one-process loss at tests/test_sharding.py's rtol 2e-4, and
after the four Adam steps of both epochs every parameter lies within
those steps' bound of the one-process run's (rtol 5e-3, atol 2 lr a step:
tests/test_sharding.py's post-Adam bar, once per step)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from facl_tpu.config import DatagenConfig
from facl_tpu.data import write_synthetic_dataset
from facl_tpu_torch.config import Config, GroupingConfig, ModelConfig
from facl_tpu_torch.parallel import spawn
from tests.torch_dp_ranks import cli_body

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_cli")
    root = tmp / "tree"
    dg = DatagenConfig(grid_shape=(24, 24, 24), image_shape=(48, 64),
                       sample_num=256, num_appearance_frames=4,
                       voxel_size=80.0, resolutions=(60, 30, 10))
    names = write_synthetic_dataset(str(root), num_videos=12, seed=0,
                                    datagen_cfg=dg)
    cfg = Config(
        grouping=GroupingConfig(num_centroids=8, knn_k=8, radius_sq=10.0),
        model=ModelConfig(sa_widths=(8, 16), stage2_widths=(16, 32),
                          fc_hidden=32, embed_dim=16, num_prototypes=8))
    cfg_file = tmp / "tiny.json"
    cfg_file.write_text(cfg.to_json())
    common = ["--root", str(root), "--config", str(cfg_file), "--dtype",
              "float32", "--device", "cpu"]
    mesh = ["--mesh", "--dist-backend", "gloo"]
    ck, ck1 = str(tmp / "ck_dp"), str(tmp / "ck_one")
    train = ["--batch-size", "4", "--epochs", "1"]
    resume = ["--batch-size", "4", "--epochs", "2", "--resume"]
    extract = ["--batch-size", "3", "--checkpoint", ck]
    ranks = spawn(cli_body, 2, "gloo", timeout_s=300, args=(
        common + mesh + train + ["--out", ck],
        common + mesh + resume + ["--out", ck],
        common + mesh + extract + ["--out", str(tmp / "feat_dp")]))
    from facl_tpu_torch.cli import extract as extract_cli
    from facl_tpu_torch.cli import pretrain
    one = pretrain.main(common + train + ["--out", ck1]) + \
        pretrain.main(common + resume + ["--out", ck1])
    extract_cli.main(common + extract + ["--out", str(tmp / "feat_one")])
    return dict(tmp=tmp, names=names, ranks=ranks, one=one, ck=ck,
                ck1=ck1, common=common, mesh=mesh, extract=extract)


def _features(d, names):
    files = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
    assert files == sorted(n + ".npy" for n in names)
    return {f: np.load(os.path.join(d, f)) for f in files}


def _assert_same_features(got, want):
    for f, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[f], w, rtol=0, atol=1e-5 * scale,
                                   err_msg=f)


def test_dp_pretrain_checkpoints_on_rank_0_and_resumes(run):
    ranks, one = run["ranks"], run["one"]
    assert [r["rank"] for r in ranks] == [0, 1]
    with open(os.path.join(run["ck"], "index.json")) as f:
        assert json.load(f) == {"latest_epoch": 1,
                                "latest": "ckpt_epoch_00001.pt"}
    assert sorted(p for p in os.listdir(run["ck"]) if p.endswith(".pt")) \
        == ["ckpt_epoch_00000.pt", "ckpt_epoch_00001.pt"]
    for r in ranks:
        assert len(r["hist"]) == len(r["hist2"]) == 1
        # The epoch mean of the global loss, the same on both ranks.
        assert r["hist"][0]["loss"] == ranks[0]["hist"][0]["loss"]
        assert r["hist2"][0]["loss"] == ranks[0]["hist2"][0]["loss"]
        # Broadcast of the state at each start, one barrier a checkpoint.
        assert r["counts"]["barrier"] == 3
        assert r["counts"]["gather_negatives"] > 0
    np.testing.assert_allclose(ranks[0]["hist"][0]["loss"], one[0]["loss"],
                               rtol=2e-4)
    dp, single = (torch.load(os.path.join(d, "ckpt_epoch_00001.pt"),
                             weights_only=True)
                  for d in (run["ck"], run["ck1"]))
    assert dp["step"] == single["step"] == 4
    lr = Config().train.optim.learning_rate
    for n, w in single["model"].items():
        np.testing.assert_allclose(dp["model"][n].numpy(), w.numpy(),
                                   rtol=5e-3, atol=4 * 2 * lr, err_msg=n)


def test_dp_extract_matches_one_process(run):
    names = run["names"]
    for r in run["ranks"]:
        assert r["written"] == len(names)
    _assert_same_features(_features(run["tmp"] / "feat_dp", names),
                          _features(run["tmp"] / "feat_one", names))


def test_dp_extract_under_torchrun(run):
    out = run["tmp"] / "feat_torchrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "facl_tpu_torch.cli.extract"]
        + run["common"] + run["mesh"] + run["extract"] + ["--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "mesh: dp=2" in proc.stdout
    names = run["names"]
    _assert_same_features(_features(out, names),
                          _features(run["tmp"] / "feat_one", names))
