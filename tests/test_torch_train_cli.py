"""The port's training CLI, ``python -m realtime_style_transfer_torch.train_network``,
called in this process at ``--device cpu`` on a tiny SDR dataset
(``tests/test_cli.py``'s fixture): one epoch writes the run directory that
``tests/test_cli.py::test_train_creates_artifacts`` expects of the JAX CLI,
and ``--continue_from`` resumes it at epoch 1."""

import json

import numpy as np
import PIL.Image
import pytest
import torch

from realtime_style_transfer_torch import train_network
from realtime_style_transfer_torch.tracing.tensorboard import read_events

torch.set_num_threads(2)
SPEC = "rst-120-15-4-3"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """tests/test_cli.py's fixture: content and style images, 3 a split."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("dataset")
    for sub in ("training", "validation"):
        for d in (root / "content" / sub, root / "style" / sub):
            d.mkdir(parents=True)
        for i in range(3):
            for d in (root / "content" / sub, root / "style" / sub):
                arr = (rng.random((70, 130, 3)) * 255).astype(np.uint8)
                PIL.Image.fromarray(arr).save(d / f"{sub}_{i}.png")
    return root


def _argv(dataset, log_dir, *extra):
    return ["--device", "cpu", "--network_spec", SPEC, "--sdr", "--loss", "dummy",
            "--no_depth_loss", "--epochs", "1", "--batch_size", "2",
            "--checkpoint_cadence", "1", "--log_dir", str(log_dir),
            "--content_dir", str(dataset / "content"), "--style_dir", str(dataset / "style"),
            "--dtype", "float32", *extra]


@pytest.fixture(scope="module")
def trained_run(dataset, tmp_path_factory):
    log_dir = tmp_path_factory.mktemp("run")
    assert train_network.main(_argv(dataset, log_dir)) == log_dir
    return log_dir


def test_train_creates_artifacts(trained_run):
    """What tests/test_cli.py::test_train_creates_artifacts asks of JAX."""
    assert (trained_run / "metrics.jsonl").exists()
    assert (trained_run / "config.json").exists()
    assert (trained_run / "weights").exists()
    metrics = [json.loads(line) for line in (trained_run / "metrics.jsonl").open()]
    tags = {m["tag"] for m in metrics}
    assert any(t.startswith("training/loss") for t in tags)
    assert any(t.startswith("validation/loss") for t in tags)
    images = list((trained_run / "images").glob("*.png"))
    assert images, "summary images missing"


def test_run_directory_is_complete(trained_run):
    assert json.loads((trained_run / "config.json").read_text())["num_channels"] == 3
    assert [p.name for p in (trained_run / "ckpt").iterdir()] == ["0.npz"]
    assert [p.name for p in (trained_run / "latest_ckpt").iterdir()] == ["0.npz"]
    assert (trained_run / "weights" / "latest_epoch_weights.npz").is_file()
    assert "total parameters" in (trained_run / "model_summary.txt").read_text()
    assert "epoch 0:" in (trained_run / "log.txt").read_text()
    (events,) = trained_run.glob("events.out.tfevents.*")
    kinds = {e["kind"] for e in read_events(events)}
    assert {"file_version", "scalar", "histogram", "image"} <= kinds
    metrics = [json.loads(line) for line in (trained_run / "metrics.jsonl").open()]
    tags = {m["tag"] for m in metrics}
    assert any(t.startswith("weights/") for t in tags)
    assert any(t.startswith("gradients/") for t in tags)
    assert all(np.isfinite(m["value"]) for m in metrics if "value" in m)


def test_continue_from_resumes_at_the_next_epoch(dataset, trained_run, tmp_path):
    run2 = train_network.main(_argv(dataset, tmp_path / "run2", "--epochs", "2",
                                    "--continue_from", str(trained_run)))
    steps = {m["step"] for m in map(json.loads, (run2 / "metrics.jsonl").open())
             if m["tag"] == "training/loss"}
    assert steps == {1}
    assert [p.name for p in (run2 / "latest_ckpt").iterdir()] == ["1.npz"]
    assert "resuming from epoch 0" in (run2 / "log.txt").read_text()
    # the first run's log file took no line of the second
    assert "resuming" not in (trained_run / "log.txt").read_text()


def test_mesh_with_a_spatial_axis_trains(dataset, tmp_path, monkeypatch):
    """``--mesh 1,2``: the CLI starts two gloo ranks and splits each frame's
    120 rows over them (64 + 56, at multiples of 8 for the 3 contracts)."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")   # the ranks' gloo on the loopback
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    run = train_network.main(_argv(dataset, tmp_path / "mesh", "--mesh", "1,2"))
    assert "mesh: {'data': 1, 'spatial': 2}, this rank 0" in (run / "log.txt").read_text()
    metrics = [json.loads(line) for line in (run / "metrics.jsonl").open()]
    losses = [m["value"] for m in metrics if m["tag"] in ("training/loss", "validation/loss")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert (run / "weights" / "latest_epoch_weights.npz").is_file()


def test_refusals(dataset, tmp_path, monkeypatch):
    # every JAX tower is a choice (the EfficientNet towers are ported)
    with pytest.raises(SystemExit):
        train_network.main(_argv(dataset, tmp_path / "effnet", "--loss", "efficientnet_b7"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(dataset, tmp_path / "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_network.main(argv[2:])   # no --device: CUDA, and an error without it
