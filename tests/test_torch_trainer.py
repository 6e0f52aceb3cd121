"""The port's trainer around the train step, against the JAX package's.

The reverse weight bridge, the loader's cycled tail and seeded shuffle,
the IPAD dataset, a 2-epoch run of ``python -m vad_tpu_torch.train_video
--device cpu`` whose checkpoints the JAX package reads, and ``--resume``
both ways.  Inputs come from numpy seeds and the synthetic IPAD data of
``tests/conftest.py``.

Bar: f32 rtol 1e-4 / atol 1e-5.
"""

import json
import os
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vad_tpu.data.loader import DistributedLoader as JaxLoader
from vad_tpu.data.video_dataset import IPADDataset as JaxIPAD
from vad_tpu.models.video_autoencoder import VideoAutoencoder as JaxVAE
from vad_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from vad_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from vad_tpu_torch.data.loader import DistributedLoader
from vad_tpu_torch.data.video_dataset import (
    IPADDataset,
    VideoDataset,
    detect_video_dataset_class,
)
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_training_weights
from vad_tpu_torch.ops.losses import mse_per_sample
from vad_tpu_torch.train.steps import make_eval_step
from vad_tpu_torch.train.video_trainer import fit, training_mesh
from vad_tpu_torch.train_video import build_parser
from vad_tpu_torch.utils.checkpoint import load_checkpoint
from vad_tpu_torch.utils.weights import load_flax_variables, state_dict_to_flax

REPO = Path(__file__).resolve().parent.parent
F32 = dict(rtol=1e-4, atol=1e-5)
SMALL = ["--latent-dim", "32", "--lstm-hidden-dim", "32", "--lstm-layers", "1",
         "--image-size", "64", "--sequence-length", "4", "--batch-size", "4"]

BEST_KEYS = {"epoch", "params", "batch_stats", "torch_opt_state", "train_loss", "val_loss",
             "separation", "normal_err", "anomaly_err", "args", "model_type",
             "score_threshold", "frame_score_threshold", "score_baseline", "threshold_method"}
FINAL_KEYS = {"epoch", "params", "batch_stats", "torch_opt_state", "history", "best_epoch",
              "best_separation", "args", "model_type", "score_threshold",
              "frame_score_threshold", "score_baseline", "threshold_method"}
EPOCH_KEYS = {"epoch", "params", "batch_stats", "separation", "args", "model_type",
              "score_threshold", "frame_score_threshold", "score_baseline", "threshold_method"}


def leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def jax_forward(variables, x, **model_kw):
    jmodel = JaxVAE(backend="xla", **model_kw)
    with jax.default_matmul_precision("highest"):
        return np.asarray(jmodel.apply({"params": variables["params"],
                                        "batch_stats": variables.get("batch_stats") or {}},
                                       jnp.asarray(x), train=False))


# ----------------------------------------------------------- weight bridge


@pytest.mark.parametrize("norm,hidden,layers", [("batch", 48, 2), ("group", 32, 1)])
def test_reverse_bridge_round_trips_and_loads_into_jax(norm, hidden, layers):
    kw = dict(latent_dim=32, lstm_hidden_dim=hidden, lstm_layers=layers, norm=norm)
    model = init_training_weights(VideoAutoencoder(device="cpu", **kw), 5)
    with torch.no_grad():  # statistics off identity, so their mapping is checked too
        for name, buf in model.named_buffers():
            if "running" in name:
                buf.uniform_(0.5, 1.5)
    tree = state_dict_to_flax(model)
    back = VideoAutoencoder(device="cpu", **kw)
    load_flax_variables(back, tree)
    for (k, a), b in zip(model.state_dict().items(), back.state_dict().values()):
        assert torch.equal(a, b), k
    # the tree has exactly the JAX model's structure and shapes
    init = JaxVAE(backend="xla", **kw).init(jax.random.key(0), jnp.zeros((1, 2, 64, 64, 3)),
                                            train=False)
    want = {k: v.shape for k, v in leaves(init).items()}
    assert {k: v.shape for k, v in leaves(tree).items()} == want
    x = np.random.default_rng(1).uniform(-1, 1, (1, 3, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, jax_forward(tree, x, **kw), **F32)


# ------------------------------------------------------- loader, dataset


class Indexed:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"frames": np.full((2, 3, 3, 3), i, np.uint8), "label": np.int64(i % 2),
                "video": f"v{i}"}


@pytest.mark.parametrize("n,batch,pad_to,workers", [(10, 4, 4, 0), (10, 4, 4, 2), (5, 3, 4, 1),
                                                    (2, 8, 8, 0)])
def test_loader_matches_jax(n, batch, pad_to, workers):
    """Batches over 2 epochs: the seeded shuffle, the cycled tail and
    n_real, as JAX's loader (assemble=False) gives them."""
    ds = Indexed(n)
    jl = JaxLoader(ds, batch, None, pad_to=pad_to, shuffle=True, num_workers=workers, seed=3,
                   assemble=False)
    tl = DistributedLoader(ds, batch, pad_to=pad_to, shuffle=True, num_workers=workers, seed=3,
                           device="cpu")
    assert len(tl) == len(jl)
    for _ in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(want)
        for (tb, tn), (jb, jn) in zip(got, want):
            assert tn == jn
            assert isinstance(tb["frames"], torch.Tensor) and tb["frames"].shape[0] == pad_to
            np.testing.assert_array_equal(tb["frames"].numpy(), jb["frames"])
            np.testing.assert_array_equal(tb["label"], jb["label"])
            assert tb["video"] == jb["video"]


def test_ipad_dataset_matches_jax(synthetic_video_root):
    for split in ("train", "test"):
        kw = dict(sequence_length=4, stride=3, image_size=64, normalize=False)
        got = IPADDataset(synthetic_video_root, "S01", split, **kw)
        want = JaxIPAD(synthetic_video_root, "S01", split, **kw)
        assert len(got) == len(want) > 0
        np.testing.assert_array_equal(got.labels, want.labels)
        for i in (0, len(got) // 2, len(got) - 1):
            a, b = got[i], want[i]
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert detect_video_dataset_class(synthetic_video_root, "S01") is IPADDataset


def test_generic_layout_and_unported_options_raise(tmp_path):
    # the generic layout is ported now: any layout that is not IPAD
    (tmp_path / "cat" / "train" / "good").mkdir(parents=True)
    assert detect_video_dataset_class(str(tmp_path), "cat") is VideoDataset
    # scaling (item 10) is ported: --model-parallel 2 needs two ranks; one
    # process has no 'model' axis to split (JAX's get_mesh error on one device)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="1 devices not divisible by model_parallel=2"):
        training_mesh(build_parser().parse_args(["--category", "x", "--model-parallel", "2"]),
                      cpu)
    # the profiling flags (Queue 1 item 11) are ported: accepted
    for flags in (["--tensorboard"], ["--profile-dir", "p"], ["--debug-nans"],
                  ["--model-parallel", "1"]):
        mesh, device = training_mesh(build_parser().parse_args(["--category", "x", *flags]),
                                     cpu)
        assert mesh.shape == {"data": 1, "model": 1} and device == cpu


def test_eval_step_scores_in_eval_mode_and_restores_the_mode():
    model = init_training_weights(
        VideoAutoencoder(latent_dim=32, lstm_hidden_dim=32, lstm_layers=1, device="cpu"), 0)
    u8 = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 3, 32, 32, 3),
                                                            dtype=np.uint8))
    step = make_eval_step(mse_per_sample,
                          lambda m, x: VideoAutoencoder.prediction_error(m, x, per_frame=True))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    losses, scores = step(model.train(), u8)
    assert model.training and losses.shape == (2,) and scores.shape == (2, 2)
    for k, v in model.state_dict().items():  # no running statistic moved
        assert torch.equal(v, before[k]), k


def test_prediction_error_matches_jax():
    kw = dict(latent_dim=32, lstm_hidden_dim=32, lstm_layers=1)
    model = init_training_weights(VideoAutoencoder(device="cpu", **kw), 3).eval()
    tree = state_dict_to_flax(model)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 3, 32, 32, 3)).astype(np.float32)
    jmodel = JaxVAE(backend="xla", **kw)
    for flags in ({}, {"per_frame": True}, {"per_pixel": True}):
        with jax.default_matmul_precision("highest"):
            want = jmodel.apply(tree, jnp.asarray(x), method=JaxVAE.prediction_error, **flags)
        with torch.no_grad():
            got = model.prediction_error(torch.from_numpy(x), **flags)
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ------------------------------------------------------------ the trainer


def test_cli_trains_and_jax_reads_its_checkpoints(synthetic_video_root, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "vad_tpu_torch.train_video", "--device", "cpu", "--category",
         "S01", "--data-dir", synthetic_video_root, "--epochs", "2", "--num-workers", "2",
         "--results-dir", str(tmp_path), "--keep-checkpoints", "1", *SMALL],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Epoch   2/2" in proc.stdout
    (run,) = tmp_path.glob("video_S01_*")
    names = sorted(p.name for p in run.iterdir())
    assert names == ["best_model.ckpt", "checkpoint_epoch_2.ckpt", "final_model.ckpt",
                     "metrics.jsonl", "training_history.png"]
    best = load_checkpoint(run / "best_model.ckpt")
    final = load_checkpoint(run / "final_model.ckpt")
    assert set(best) == BEST_KEYS and set(final) == FINAL_KEYS
    assert set(load_checkpoint(run / "checkpoint_epoch_2.ckpt")) == EPOCH_KEYS
    assert final["epoch"] == 2 and len(final["history"]["separation"]) == 2
    assert best["args"]["device"] == "cpu" and best["model_type"] == "video"
    assert best["score_baseline"]["count"] > 0 and best["frame_score_threshold"] is not None
    records = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2] and all("separation" in r for r in records)

    # the JAX package reads the port's checkpoint into its own model
    ck = jax_load_checkpoint(run / "best_model.ckpt")
    x = np.random.default_rng(5).uniform(-1, 1, (1, 4, 64, 64, 3)).astype(np.float32)
    model = VideoAutoencoder(latent_dim=32, lstm_hidden_dim=32, lstm_layers=1, device="cpu")
    load_flax_variables(model, {"params": ck["params"], "batch_stats": ck["batch_stats"]})
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, jax_forward(ck, x, latent_dim=32, lstm_hidden_dim=32, lstm_layers=1), **F32)


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


def _args(tmp_path, **over):
    args = build_parser().parse_args(
        ["--category", "mem", "--device", "cpu", "--latent-dim", "32", "--lstm-hidden-dim",
         "32", "--lstm-layers", "1", "--image-size", "32", "--sequence-length", "3",
         "--batch-size", "2", "--num-workers", "0", "--results-dir", str(tmp_path)])
    return Namespace(**{**vars(args), **over})


def test_resume_own_and_jax_checkpoints(tmp_path, capsys):
    """Resuming a port checkpoint restores Adam's state; resuming a JAX one
    loads its weights and restarts the moments."""
    train_ds, test_ds = Windows([0] * 4, 1), Windows([0, 1, 0, 1], 2)
    first = fit(_args(tmp_path, epochs=1), train_ds, test_ds, "cpu")
    final = first["results_dir"] / "final_model.ckpt"
    resumed = fit(_args(tmp_path, epochs=2, resume=str(final)), train_ds, test_ds, "cpu")
    assert resumed["results_dir"] == first["results_dir"]
    assert len(resumed["history"]["separation"]) == 2
    assert "Adam moments restart" not in capsys.readouterr().out
    ck = load_checkpoint(resumed["results_dir"] / "final_model.ckpt")
    assert int(ck["torch_opt_state"]["state"][0]["step"]) == 4  # 2 epochs x 2 steps

    # a checkpoint as the JAX trainer writes it (optax state under opt_state)
    jax_dir = tmp_path / "jax_run"
    jax_save_checkpoint(jax_dir / "best_model.ckpt", {
        "params": ck["params"], "batch_stats": ck["batch_stats"], "opt_state": None,
        "epoch": 1, "args": ck["args"]})
    out = fit(_args(tmp_path, epochs=2, resume=str(jax_dir / "best_model.ckpt")), train_ds,
              test_ds, "cpu")
    assert "Adam moments restart" in capsys.readouterr().out
    assert out["results_dir"] == jax_dir and len(out["history"]["separation"]) == 1
