"""The port's UI (``vad_tpu_torch/ui``): the gradio app driven through
``tests/gradio_stub.py`` as ``tests/test_ui_app.py`` drives the JAX
package's, and the logic against the JAX package's on one checkpoint, on
the CPU (f32 parity bar rtol 1e-4 / atol 1e-5).

Checkpoints: the port's ``init_weights`` at latent 16 (hidden 16) and
64x64, written with the JAX package's ``save_checkpoint``; inputs from a
numpy seed.
"""

import re
import sys

import numpy as np
import pytest
import torch

from tests.gradio_stub import install
from vad_tpu.ui import logic as jax_logic
from vad_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from vad_tpu_torch.models.autoencoder import ConvAutoencoder
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
from vad_tpu_torch.ui import __main__ as ui_main
from vad_tpu_torch.ui import logic
from vad_tpu_torch.ui.logic import AppState
from vad_tpu_torch.utils.weights import state_dict_to_flax

F32 = dict(rtol=1e-4, atol=1e-5)
EXPECTED_TABS = ["Analyze Images", "Analyze Video", "Train Image Model", "Train Video Model",
                 "View Results", "Help"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("results")
    img_dir, vid_dir = root / "synthetic_20260101_000000", root / "video_S01_20260101_000000"
    img_dir.mkdir()
    vid_dir.mkdir()
    image = init_weights(ConvAutoencoder(latent_dim=16, device="cpu"), 0)
    jax_save_checkpoint(img_dir / "best_model.ckpt", {
        **state_dict_to_flax(image), "epoch": 1, "train_loss": 0.01, "model_type": "image",
        "args": {"latent_dim": 16, "image_size": 64, "category": "synthetic"}})
    video = init_weights(VideoAutoencoder(latent_dim=16, lstm_hidden_dim=16, device="cpu"), 1)
    jax_save_checkpoint(vid_dir / "best_model.ckpt", {
        **state_dict_to_flax(video), "epoch": 1, "separation": 1.2, "model_type": "video",
        "frame_score_threshold": 0.3,
        "args": {"latent_dim": 16, "lstm_hidden_dim": 16, "lstm_layers": 2, "image_size": 64,
                 "sequence_length": 4, "category": "S01"}})
    return {"image": str(img_dir / "best_model.ckpt"), "video": str(vid_dir / "best_model.ckpt"),
            "root": str(root)}


@pytest.fixture
def ui(monkeypatch):
    rec = install(monkeypatch)
    from vad_tpu_torch.ui import app

    state = AppState("cpu")
    blocks = app.create_ui(state)
    return rec, blocks, state


def test_create_ui_builds_six_tabs(ui):
    rec, _, _ = ui
    assert rec.tabs == EXPECTED_TABS
    assert len(rec.components) > 30


def test_launch_passes_host_port_and_device(monkeypatch):
    rec = install(monkeypatch)
    from vad_tpu_torch.ui import app

    app.launch(host="127.0.0.1", port=7999, device="cpu")
    assert rec.launched == {"server_name": "127.0.0.1", "server_port": 7999, "share": False}


def test_all_expected_buttons_wired(ui):
    rec, _, _ = ui
    wired = sorted(c["button"].label for c in rec.clicks)
    assert wired == sorted(["Refresh", "Refresh", "Refresh", "Load Model", "Load Model",
                            "Analyze Image", "Analyze Video", "Start Training",
                            "Start Video Training", "Run Evaluation", "View Existing Results"])
    assert all(callable(c["fn"]) for c in rec.clicks)


def test_load_and_analyze_image_matches_jax(ui, checkpoints):
    """The port's analysis scores the image as the JAX package's does (the
    JAX score from its own model on the same resized input), and the
    reports differ only in the backend line."""
    rec, _, state = ui
    status = rec.clicks_for("Load Model")[0]["fn"](checkpoints["image"])
    jstate = jax_logic.AppState()
    jstatus = jstate.load_image_model(checkpoints["image"])
    assert status.replace("PyTorch/CPU", "JAX/TPU") == jstatus

    analyze = rec.click_for("Analyze Image")
    img = np.random.default_rng(0).integers(0, 255, (48, 48, 3), dtype=np.uint8)
    recon, heat, report = analyze["fn"](img)
    assert recon.shape == (64, 64, 3) and recon.dtype == np.uint8 and heat is not None
    _, _, score = logic.score_image(state, img)
    _, _, jreport = jax_logic.analyze_image(jstate, img)
    from PIL import Image

    x = np.asarray(Image.fromarray(img).resize((64, 64), Image.BILINEAR), np.float32)[None]
    x = x / 127.5 - 1.0
    jrecon = np.asarray(jstate.model.apply(jstate.variables, x, train=False))
    np.testing.assert_allclose(score, np.mean(np.square(x - jrecon)), **F32)
    pattern = r"Anomaly Score: ([0-9.]+)"
    assert abs(float(re.search(pattern, report)[1]) - float(re.search(pattern, jreport)[1])) \
        <= 2e-6
    assert "upload an image" in analyze["fn"](None)[2]


def test_load_and_analyze_video_matches_jax(ui, checkpoints, tmp_path):
    pytest.importorskip("cv2")
    from vad_tpu.data.synthetic import create_synthetic_video_file

    rec, _, state = ui
    status = rec.clicks_for("Load Model")[1]["fn"](checkpoints["video"])
    assert "Video model loaded successfully" in status and "PyTorch/CPU" in status
    clip = tmp_path / "clip.mp4"
    create_synthetic_video_file(str(clip), n_frames=10, image_size=64, seed=0)
    timeline, report = rec.click_for("Analyze Video")["fn"](str(clip))
    assert timeline is not None and "VIDEO ANALYSIS COMPLETE" in report
    jstate = jax_logic.AppState()
    jstate.load_video_model(checkpoints["video"])
    _, jreport = jax_logic.analyze_video(jstate, str(clip))
    assert report.splitlines()[:4] == jreport.splitlines()[:4]  # header and frame count
    from vad_tpu.eval.video_render import stream_scores as jax_stream_scores

    want = jax_stream_scores(jstate.video_model, jstate.video_variables, str(clip), 64, chunk=4)
    np.testing.assert_allclose(logic.video_scores(state, str(clip)), want, **F32)
    assert "upload a video" in rec.click_for("Analyze Video")["fn"](None)[1]


def test_reports_match_jax():
    scores = np.random.default_rng(1).uniform(0, 0.01, 40)
    scores[7] = 0.2
    for calibrated in (None, 0.005):
        assert logic.video_report(scores, calibrated) == jax_logic.video_report(scores, calibrated)
    for score in (0.001, 0.004, 0.009):
        assert logic.image_report(score) == jax_logic.image_report(score)


def test_discovery_matches_jax(checkpoints, tmp_path):
    for kind in ("image", "video", "all"):
        assert (logic.discover_checkpoints(kind, checkpoints["root"])
                == jax_logic.discover_checkpoints(kind, checkpoints["root"]))
    (tmp_path / "bottle" / "train").mkdir(parents=True)
    (tmp_path / "IPAD" / "S01" / "training" / "frames").mkdir(parents=True)
    (tmp_path / "conveyor" / "train" / "normal" / "vid01").mkdir(parents=True)
    assert (logic.discover_image_categories((str(tmp_path),))
            == jax_logic.discover_image_categories((str(tmp_path),)))
    args = (str(tmp_path / "IPAD"), str(tmp_path))
    assert logic.discover_video_categories(*args) == jax_logic.discover_video_categories(*args)


def test_training_callbacks_run_the_ports_clis(ui, monkeypatch):
    rec, _, _ = ui
    seen = {}

    def fake_stream(cmd, header, tail=40):
        seen["cmd"] = cmd
        yield header + "epoch 1 done"

    monkeypatch.setattr(logic, "stream_subprocess", fake_stream)
    monkeypatch.setattr(logic, "find_data_dir_for_category", lambda c, video=False: "./data")
    out = list(rec.click_for("Start Training")["fn"]("synthetic", 10, 8, 0.001, "mse"))
    assert "TRAINING STARTED" in out[-1] and "epoch 1 done" in out[-1]
    assert seen["cmd"][1:3] == ["-m", "vad_tpu_torch.train"]
    assert seen["cmd"][-2:] == ["--device", "cpu"] and "--loss" in seen["cmd"]
    vtrain = rec.click_for("Start Video Training")
    assert "VIDEO TRAINING STARTED" in list(vtrain["fn"]("S01", 5, 2, 0.0001))[-1]
    assert seen["cmd"][1:3] == ["-m", "vad_tpu_torch.train_video"]
    assert list(vtrain["fn"](None, 1, 1, 0.1)) == ["Error: No video dataset found."]
    monkeypatch.setattr(logic, "find_data_dir_for_category", lambda c, video=False: None)
    assert "Could not find dataset" in list(
        rec.click_for("Start Training")["fn"]("x", 1, 1, 0.1, "mse"))[0]


def test_eval_command_names_the_ports_evaluators(checkpoints, tmp_path):
    (tmp_path / "S01").mkdir()
    (tmp_path / "synthetic").mkdir()
    for kind, module in (("video", "vad_tpu_torch.evaluate_video"),
                         ("image", "vad_tpu_torch.evaluate")):
        from vad_tpu.utils.checkpoint import load_checkpoint as jax_load

        ckpt = jax_load(checkpoints[kind])
        path = tmp_path / f"{'video_' if kind == 'video' else ''}run" / "best_model.ckpt"
        path.parent.mkdir()
        jax_save_checkpoint(path, {**ckpt, "args": {**ckpt["args"], "data_dir": str(tmp_path)}})
        cmd = logic.build_eval_command(str(path), "cpu")
        assert cmd[1:3] == ["-m", module] and cmd[-2:] == ["--device", "cpu"]
        assert cmd[3:9] == jax_logic.build_eval_command(str(path))[2:]


def test_run_evaluation_callback(ui, checkpoints, monkeypatch):
    from pathlib import Path

    rec, _, _ = ui
    monkeypatch.setattr(logic, "stream_subprocess",
                        lambda cmd, header, tail=40: iter([header + "AUROC: 0.95"]))
    monkeypatch.setattr(logic, "build_eval_command", lambda ckpt, device: ["python", "-m", "x"])
    eval_dir = Path(checkpoints["image"]).parent / "evaluation"
    eval_dir.mkdir(exist_ok=True)
    (eval_dir / "results.txt").write_text("AUROC: 0.9500\n")
    run_eval = rec.click_for("Run Evaluation")
    status, _, _, _, summary = run_eval["fn"](checkpoints["image"])
    assert "AUROC: 0.95" in status and "AUROC: 0.9500" in summary
    assert "select a checkpoint" in run_eval["fn"]("")[0]
    assert rec.click_for("View Existing Results")["fn"] is logic.load_results_artifacts


def test_no_model_and_missing_checkpoint_paths():
    state = AppState("cpu")
    assert "load a model first" in logic.analyze_image(state, np.zeros((8, 8, 3), np.uint8))[2]
    assert "load a video model first" in logic.analyze_video(state, "x.mp4")[1]
    assert state.load_image_model("missing.ckpt") == "Error: Checkpoint file not found."


def test_main_without_gradio_lists_the_ports_clis(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "gradio", None)
    assert ui_main.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "python -m vad_tpu_torch.train_video" in out and "pip install gradio" in out


def test_state_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AppState()
