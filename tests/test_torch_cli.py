"""The port's user flow on the CPU: ``facl_tpu_torch.cli.pretrain`` (one
epoch, then ``--resume`` to two), ``extract`` for both streams and
``probe``, through their main() entry points with ``--device cpu``, on
the tiny tree the JAX generator writes and the tiny config of
tests/test_cli_e2e.py (the JAX twin of this flow). Also the port's
logging and profiling utilities."""
import json
import logging
import os

import numpy as np
import pytest
import torch

from facl_tpu.config import DatagenConfig
from facl_tpu.data import write_synthetic_dataset
from facl_tpu_torch.config import Config, GroupingConfig, ModelConfig


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_tree")
    dg = DatagenConfig(grid_shape=(24, 24, 24), image_shape=(48, 64),
                       sample_num=256, num_appearance_frames=4,
                       voxel_size=80.0, resolutions=(60, 30, 10))
    names = write_synthetic_dataset(str(root), num_videos=6, seed=0,
                                    datagen_cfg=dg)
    return str(root), names


@pytest.fixture(scope="module")
def tiny_cfg_file(tmp_path_factory):
    cfg = Config(
        grouping=GroupingConfig(num_centroids=8, knn_k=8, radius_sq=10.0),
        model=ModelConfig(sa_widths=(8, 16), stage2_widths=(16, 32),
                          fc_hidden=32, embed_dim=16, num_prototypes=8),
    )
    p = tmp_path_factory.mktemp("cfg") / "tiny.json"
    p.write_text(cfg.to_json())
    return str(p)


def test_pretrain_resume_extract_probe(cli_root, tiny_cfg_file, tmp_path,
                                       capsys):
    from facl_tpu_torch.cli import extract, pretrain, probe
    root, names = cli_root
    feats = {}
    for stream in ("motion", "appearance"):
        ck = str(tmp_path / f"ck_{stream}")
        common = ["--root", root, "--stream", stream, "--batch-size", "2",
                  "--dtype", "float32", "--config", tiny_cfg_file,
                  "--device", "cpu"]
        hist = pretrain.main(common + ["--epochs", "1", "--out", ck])
        assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
        with open(os.path.join(ck, "index.json")) as f:
            assert json.load(f) == {"latest_epoch": 0,
                                    "latest": "ckpt_epoch_00000.pt"}
        # Resume: runs epochs [1, 2) on top of the restored state.
        hist = pretrain.main(common + ["--epochs", "2", "--out", ck,
                                       "--resume"])
        assert len(hist) == 1
        with open(os.path.join(ck, "index.json")) as f:
            assert json.load(f)["latest_epoch"] == 1

        feat = feats[stream] = str(tmp_path / f"feat_{stream}")
        assert extract.main(common + ["--checkpoint", ck, "--out", feat]) \
            == len(names)
        files = sorted(n for n in os.listdir(feat) if n.endswith(".npy"))
        assert files == sorted(n + ".npy" for n in names)
        for n in files:
            f0 = np.load(os.path.join(feat, n))
            assert f0.shape == (11 * 16,)       # (G + 1) * embed_dim
            assert np.isfinite(f0).all()

    capsys.readouterr()
    best = probe.main(["--root", root, "--motion-features", feats["motion"],
                       "--appearance-features", feats["appearance"],
                       "--epochs", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"top1={best['top1']:.2f}" in out.splitlines()
    assert 0.0 <= best["top1"] <= 100.0


def test_cli_errors(cli_root, tiny_cfg_file, tmp_path, monkeypatch):
    from facl_tpu_torch.cli import extract, pretrain
    root, _ = cli_root
    common = ["--root", root, "--config", tiny_cfg_file, "--device", "cpu"]
    with pytest.raises(SystemExit, match="no checkpoint"):
        extract.main(common + ["--checkpoint", str(tmp_path / "none"),
                               "--out", str(tmp_path / "f")])
    # --mesh with nccl (the default backend) on more ranks than cards:
    # raised before any rendezvous, never a silent switch to gloo.
    with monkeypatch.context() as m:
        for k, v in (("WORLD_SIZE", "2"), ("LOCAL_WORLD_SIZE", "2"),
                     ("RANK", "0"), ("LOCAL_RANK", "0")):
            m.setenv(k, v)
        with pytest.raises(RuntimeError, match="nccl needs one CUDA device"):
            pretrain.main(common + ["--mesh", "--out", str(tmp_path / "c")])
    with pytest.raises(SystemExit, match="fewer than --batch-size"):
        pretrain.main(common + ["--batch-size", "64",
                                "--out", str(tmp_path / "c")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pretrain.main(["--root", root, "--config", tiny_cfg_file,
                           "--batch-size", "2", "--out",
                           str(tmp_path / "c")])


def test_logging_and_profiling(tmp_path, capsys):
    from facl_tpu_torch.utils import AverageMeter, StepTimer, setup_logging, \
        trace
    logfile = tmp_path / "run.log"
    setup_logging(logfile=str(logfile))
    logging.getLogger("t").info("hello")
    assert "hello" in logfile.read_text()
    m = AverageMeter("loss")
    m.update(1.0, 2)
    m.update(4.0)
    assert (m.val, m.sum, m.count, m.avg) == (4.0, 6.0, 3, 2.0)
    assert str(m) == "loss 4.0000 (2.0000)"

    timer = StepTimer(clips_per_step=8, warmup=1, device="cpu")
    with trace(str(tmp_path / "prof")):
        for _ in range(3):
            with timer:
                torch.ones(64, 64) @ torch.ones(64, 64)
    assert len(timer.times) == 3 and len(timer.steady_times) == 2
    assert timer.clips_per_sec() == pytest.approx(
        8 / timer.mean_step_seconds)
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])
    with trace(None):
        pass
