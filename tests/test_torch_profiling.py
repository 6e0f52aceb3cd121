"""The port's profiling tools (``vad_tpu_torch/utils/profiling.py``) and the
trainers' ``--tensorboard``, ``--profile-dir`` and ``--debug-nans``, against
the JAX package's where it has a counterpart, on the CPU at a small size
(latent 32, hidden 32, one ConvLSTM layer, 32x32 windows; 64x64 images)."""

import builtins
import json
from argparse import Namespace

import numpy as np
import pytest
import torch

from vad_tpu.utils import profiling as jax_profiling
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_training_weights
from vad_tpu_torch.ops.losses import mse_per_sample
from vad_tpu_torch.train import __main__ as image_cli
from vad_tpu_torch.train.state import make_optimizer
from vad_tpu_torch.train.steps import make_train_step
from vad_tpu_torch.train.video_trainer import fit, nan_debugging
from vad_tpu_torch.train_video import build_parser
from vad_tpu_torch.utils import profiling


def _scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(logdir))
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_step_timer_summary_matches_jax_keys():
    ours, theirs = profiling.StepTimer(), jax_profiling.StepTimer()
    assert ours.summary() == theirs.summary() == {"count": 0}
    for timer in (ours, theirs):
        for _ in range(3):
            with timer.step():
                pass
    assert ours.summary().keys() == theirs.summary().keys()
    assert ours.summary()["count"] == 3
    with pytest.raises(RuntimeError):
        profiling.StepTimer().stop()


def test_tensorboard_writer_events_read_back_as_jax_writes_them(tmp_path):
    pytest.importorskip("tensorboard")
    for name, writer_cls in (("ours", profiling.TensorBoardWriter),
                             ("theirs", jax_profiling.TensorBoardWriter)):
        writer = writer_cls(tmp_path / name)
        for step, value in ((1, 0.5), (2, 0.25)):
            writer.scalar("loss", value, step)
        writer.close()
    assert _scalars(tmp_path / "ours") == _scalars(tmp_path / "theirs") == {
        "loss": [(1, 0.5), (2, 0.25)]}


def test_metrics_logger_tensorboard_tee(tmp_path):
    """Numeric metrics become scalars under ``<run_dir>/tb/`` (strings are
    skipped), the JSONL stream is unchanged, and without the flag there is
    no ``tb`` directory."""
    pytest.importorskip("tensorboard")
    logger = profiling.MetricsLogger(tmp_path, tensorboard=True)
    logger.log(1, loss=0.5, separation=np.float32(1.25), note="warmup")
    logger.log(2, loss=0.25)
    logger.close()
    scalars = _scalars(tmp_path / "tb")
    assert set(scalars) == {"loss", "separation"} and scalars["loss"] == [(1, 0.5), (2, 0.25)]
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [1, 2]
    plain = profiling.MetricsLogger(tmp_path / "plain")
    plain.log(1, loss=0.5)
    assert plain.tb is None and not (tmp_path / "plain" / "tb").exists()


def test_tensorboard_writer_is_a_noop_without_the_package(tmp_path, monkeypatch, capsys):
    real_import = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("tensorboard"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    writer = profiling.TensorBoardWriter(tmp_path / "tb")
    writer.scalar("loss", 1.0, 1)
    writer.flush()
    writer.close()
    assert not (tmp_path / "tb").exists()
    assert capsys.readouterr().out.count("TensorBoard unavailable") == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "trace"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "trace").glob("*.pt.trace.json")
    assert "traceEvents" in json.loads(path.read_text())


def test_nan_loss_raises_floating_point_error():
    """``debug_nans``: a non-finite loss raises before the optimizer step,
    so the weights keep their values; without it the step returns NaN."""
    model = init_training_weights(VideoAutoencoder(latent_dim=32, lstm_hidden_dim=32,
                                                   lstm_layers=1, device="cpu"), 0)
    optimizer = make_optimizer(model.parameters(), 1e-3)
    batch = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 3, 32, 32, 3),
                                                               dtype=np.uint8))
    nan_loss = lambda recon, x: mse_per_sample(recon, x) * float("nan")  # noqa: E731
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(FloatingPointError, match="nan"):
        make_train_step(nan_loss, debug_nans=True)(model, optimizer, batch, 2)
    for key, value in model.state_dict().items():
        if "running" not in key and "num_batches" not in key:  # BN statistics do move
            assert torch.equal(value, before[key]), key
    assert torch.isnan(make_train_step(nan_loss)(model, optimizer, batch, 2))


def test_nan_debugging_is_anomaly_mode_for_the_run():
    assert not torch.is_anomaly_enabled()
    with nan_debugging(Namespace(debug_nans=True)):
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()
    with nan_debugging(Namespace(debug_nans=False)):
        assert not torch.is_anomaly_enabled()
    with profiling.enable_nan_debugging(True):
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()


class Windows:
    """In-memory u8 windows with the IPAD dataset's sample keys."""

    def __init__(self, labels, seed):
        rng = np.random.default_rng(seed)
        self.labels = np.asarray(labels, np.int64)
        self.frames = rng.integers(0, 256, (len(labels), 3, 32, 32, 3), dtype=np.uint8)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return {"frames": self.frames[i], "label": self.labels[i]}


def test_video_trainer_takes_the_three_flags(tmp_path, monkeypatch):
    """``--tensorboard --profile-dir --debug-nans``: epoch scalars under
    ``<run>/tb/``, a trace of the second epoch only, anomaly mode during
    the run and not after it."""
    pytest.importorskip("tensorboard")
    seen = []
    real_step = make_train_step

    def spy(*args, **kwargs):
        step = real_step(*args, **kwargs)
        return lambda *a: (seen.append((torch.is_anomaly_enabled(), kwargs["debug_nans"]))
                           or step(*a))

    monkeypatch.setattr("vad_tpu_torch.train.video_trainer.make_train_step", spy)
    args = build_parser().parse_args(
        ["--category", "mem", "--device", "cpu", "--latent-dim", "32", "--lstm-hidden-dim",
         "32", "--lstm-layers", "1", "--image-size", "32", "--sequence-length", "3",
         "--batch-size", "2", "--num-workers", "0", "--results-dir", str(tmp_path / "r"),
         "--epochs", "2", "--tensorboard", "--profile-dir", str(tmp_path / "trace"),
         "--debug-nans"])
    result = fit(args, Windows([0] * 4, 1), Windows([0, 1, 0, 1], 2), "cpu")
    assert seen and all(s == (True, True) for s in seen)
    assert not torch.is_anomaly_enabled()
    assert len(list((tmp_path / "trace").glob("*.pt.trace.json"))) == 1
    scalars = _scalars(result["results_dir"] / "tb")
    assert [s for s, _ in scalars["separation"]] == [1, 2]
    assert {"train_loss", "val_loss", "lr", "epoch_seconds"} <= set(scalars)


def test_image_trainer_takes_the_three_flags(synthetic_image_root, tmp_path):
    pytest.importorskip("tensorboard")
    image_cli.main(["--device", "cpu", "--category", "synthetic", "--data-dir",
                    synthetic_image_root, "--image-size", "64", "--latent-dim", "16",
                    "--batch-size", "6", "--num-workers", "0", "--epochs", "2",
                    "--results-dir", str(tmp_path / "r"), "--tensorboard", "--profile-dir",
                    str(tmp_path / "trace"), "--debug-nans"])
    assert not torch.is_anomaly_enabled()
    (run,) = (tmp_path / "r").iterdir()
    assert len(list((tmp_path / "trace").glob("*.pt.trace.json"))) == 1
    assert [s for s, _ in _scalars(run / "tb")["val_loss"]] == [1, 2]
