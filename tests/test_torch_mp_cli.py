"""The port's CLIs under tensor parallelism on the CPU: a config whose
mesh is dp = 1 x mp = 2 (``{"mesh": {"dp": 1, "mp": 2}}``), with a head of
512 columns so that the mp rule splits its two Denses, through ``pretrain
--mesh`` (one epoch, then ``--resume`` to two), ``extract --mesh``, the
``slow_fast`` route of ``pretrain --mesh`` and ``moco --mesh``, each
through its main() on two gloo ranks the launcher starts, on the tiny
tree the JAX generator writes (tests/test_torch_dp_cli.py's); then
``extract`` under ``torchrun``. Against the same CLIs on one process:
each first epoch's mean loss at tests/test_sharding.py's rtol 2e-4; the
checkpoints (written whole by rank 0) within the post-Adam bar once per
step (rtol 5e-3, atol 2 lr a step); the features at 1e-5 of their
scale."""
import dataclasses
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
from facl_tpu_torch.config import Config, GroupingConfig, MeshConfig, \
    ModelConfig
from facl_tpu_torch.parallel import spawn
from tests.torch_moco_ranks import cli_body

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp_cli")
    root = tmp / "tree"
    dg = DatagenConfig(grid_shape=(24, 24, 24), image_shape=(48, 64),
                       sample_num=256, num_appearance_frames=4,
                       voxel_size=80.0, resolutions=(60, 30, 10))
    names = write_synthetic_dataset(str(root), num_videos=12, seed=0,
                                    datagen_cfg=dg)
    cfg = Config(
        grouping=GroupingConfig(num_centroids=8, knn_k=8, radius_sq=10.0),
        model=ModelConfig(sa_widths=(8, 16), stage2_widths=(16, 32),
                          fc_hidden=512, embed_dim=512, num_prototypes=8),
        mesh=MeshConfig(dp=1, mp=2))
    sf = cfg.replace(model=dataclasses.replace(
        cfg.model, name="slow_fast", slow_widths1=(4, 8),
        slow_widths3=(8, 16), fast_widths1=(4, 8), fast_widths3=(8, 16)))
    files = {}
    for name, c in (("tiny", cfg), ("sf", sf)):
        files[name] = tmp / f"{name}.json"
        files[name].write_text(c.to_json())
    common = ["--root", str(root), "--dtype", "float32", "--device", "cpu"]
    pre = common + ["--config", str(files["tiny"]), "--batch-size", "4"]
    train, resume = ["--epochs", "1"], ["--epochs", "2", "--resume"]
    extract = common + ["--config", str(files["tiny"]), "--batch-size", "3"]
    slowfast = common + ["--config", str(files["sf"]), "--batch-size", "4",
                         "--epochs", "1"]
    moco = common + ["--config", str(files["tiny"]), "--batch-size", "4",
                     "--queue-len", "8", "--epochs", "1"]
    mesh = ["--mesh", "--dist-backend", "gloo"]

    def calls(tag, extra):
        ck = str(tmp / f"ck_{tag}")
        return [("pretrain", pre + train + extra + ["--out", ck]),
                ("pretrain", pre + resume + extra + ["--out", ck]),
                # Both extract the two-rank run's checkpoint.
                ("extract", extract + extra + [
                    "--checkpoint", str(tmp / "ck_mp"), "--out",
                    str(tmp / f"feat_{tag}")]),
                ("pretrain", slowfast + extra + ["--out",
                                                 str(tmp / f"sf_{tag}")]),
                ("moco", moco + extra + ["--out", str(tmp / f"moco_{tag}")])]
    ranks = spawn(cli_body, 2, "gloo", timeout_s=300,
                  args=(calls("mp", mesh),))
    import importlib
    one = [importlib.import_module(f"facl_tpu_torch.cli.{n}").main(list(a))
           for n, a in calls("one", [])]
    return dict(tmp=tmp, names=names, ranks=ranks, one=one, mesh=mesh,
                extract=extract)


def _features(d, names):
    files = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
    assert files == sorted(n + ".npy" for n in names)
    return {f: np.load(os.path.join(d, f)) for f in files}


def _assert_same_features(got, want):
    for f, w in want.items():
        np.testing.assert_allclose(got[f], w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=f)


@pytest.mark.parametrize("call,what", [(0, "pretrain"), (3, "slow_fast"),
                                       (4, "moco")])
def test_mp_cli_trains_as_one_process(run, call, what):
    """The first epoch's mean loss, equal on the ranks (the resumed
    epoch's is held through its checkpoint below: after Adam's first
    steps the runs part by +-lr moves of round-off gradients)."""
    ranks, one = run["ranks"], run["one"]
    for r in ranks:
        hist = r["results"][call]
        assert [h["loss"] for h in hist] == \
            [h["loss"] for h in ranks[0]["results"][call]]
        np.testing.assert_allclose([h["loss"] for h in hist],
                                   [h["loss"] for h in one[call]],
                                   rtol=2e-4, err_msg=what)


def test_mp_pretrain_checkpoint_is_whole_and_resumes(run):
    tmp = run["tmp"]
    with open(tmp / "ck_mp" / "index.json") as f:
        assert json.load(f) == {"latest_epoch": 1,
                                "latest": "ckpt_epoch_00001.pt"}
    mp, single = (torch.load(tmp / d / "ckpt_epoch_00001.pt",
                             weights_only=True) for d in ("ck_mp", "ck_one"))
    assert mp["step"] == single["step"] == 4
    lr = Config().train.optim.learning_rate
    for n, w in single["model"].items():
        assert mp["model"][n].shape == w.shape, n      # written whole
        np.testing.assert_allclose(mp["model"][n].numpy(), w.numpy(),
                                   rtol=5e-3, atol=4 * 2 * lr, err_msg=n)
    names = list(single["model"])
    for i, per in single["optimizer"]["state"].items():
        for k, w in per.items():
            assert mp["optimizer"]["state"][i][k].shape == w.shape, \
                (names[i], k)
    for r in run["ranks"]:
        assert [h["loss"] for h in r["results"][1]] == \
            [h["loss"] for h in run["ranks"][0]["results"][1]]
        # The state's placement at each start (one broadcast), one
        # barrier a checkpoint; no dp collective at dp = 1.
        assert r["counts"]["broadcast"] >= 2 and r["counts"]["barrier"] > 0
        assert "gather_negatives" not in r["counts"]


def test_mp_extract_matches_one_process(run):
    names = run["names"]
    for r in run["ranks"]:
        assert r["results"][2] == len(names)
    _assert_same_features(_features(run["tmp"] / "feat_mp", names),
                          _features(run["tmp"] / "feat_one", names))


def test_mp_extract_under_torchrun(run):
    out = run["tmp"] / "feat_torchrun"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "facl_tpu_torch.cli.extract"]
        + run["extract"] + run["mesh"]
        + ["--checkpoint", str(run["tmp"] / "ck_mp"), "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "mesh: dp=1 mp=2" in proc.stdout
    names = run["names"]
    _assert_same_features(_features(out, names),
                          _features(run["tmp"] / "feat_one", names))
