"""The port's batch scoring (``evaluate_video --video-dir``) and single-video
rendering (``--video``) against the JAX package's, on the CPU.

Clips batched over ``MultiStreamScorer`` slots score as the JAX batch
scorer does and as each clip scored alone; slots recycle when there are
more clips than slots; a file or frame source that fails does not abort
the batch; ``batch_scores.json`` has the JAX schema.  The model is small
(latent and hidden 16, two ConvLSTM layers, 32x32 frames) with weights
from a seeded JAX init.

Bar: f32 rtol 1e-4 / atol 1e-5.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vad_tpu.data.synthetic import create_synthetic_video_file
from vad_tpu.eval import batch_score as jax_batch
from vad_tpu.eval import video_render as jax_render
from vad_tpu.models.video_autoencoder import VideoAutoencoder as JaxVAE
from vad_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from vad_tpu_torch import evaluate_video as cli
from vad_tpu_torch.eval import batch_score, video_render
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
from vad_tpu_torch.utils.weights import load_flax_variables

F32 = dict(rtol=1e-4, atol=1e-5)
SIZE, CHUNK = 32, 8
KW = dict(latent_dim=16, lstm_hidden_dim=16, lstm_layers=2)
LENGTHS = {"a.mp4": 16, "b.mp4": 5, "c.mp4": 35}  # a whole chunk, a short one, a tail


@pytest.fixture(scope="module")
def small():
    jmodel = JaxVAE(backend="xla", **KW)
    variables = jmodel.init(jax.random.key(1), jnp.zeros((1, 2, SIZE, SIZE, 3)), train=False)
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.0, 0.5, np.shape(a)).astype(np.float32),
        variables["batch_stats"])
    return jmodel, {"params": variables["params"], "batch_stats": stats}


def port_model():
    return VideoAutoencoder(device="cpu", **KW)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("clips")
    paths = {}
    for i, (name, n) in enumerate(LENGTHS.items()):
        paths[str(root / name)] = n
        create_synthetic_video_file(str(root / name), n_frames=n, image_size=SIZE, seed=i,
                                    anomaly_range=(10, 14) if n > 14 else None)
    return root, paths


def frames_of(path):
    return [f for raw, n in video_render.iter_video_chunks(path, 1, SIZE) for f in raw[:n]]


@pytest.mark.parametrize("slots", [2, None], ids=["recycled", "one_each"])
def test_score_videos_matches_jax_and_each_clip_alone(small, clips, slots):
    jmodel, variables = small
    _, paths = clips
    got = batch_score.score_videos(port_model(), variables, list(paths), SIZE, CHUNK,
                                   num_slots=slots)
    want = jax_batch.score_videos(jmodel, variables, list(paths), SIZE, CHUNK, num_slots=slots)
    assert set(got) == set(want) == set(paths)
    alone_model = load_flax_variables(port_model(), variables)
    for path, n_frames in paths.items():
        assert got[path]["error"] is None
        assert len(got[path]["scores"]) == n_frames  # every frame scored once
        np.testing.assert_allclose(got[path]["scores"], want[path]["scores"], **F32)
        alone = video_render.stream_scores(alone_model, None, path, SIZE, chunk=CHUNK)
        np.testing.assert_allclose(got[path]["scores"], alone, **F32)


def test_frame_sources_stand_in_for_paths(small, clips):
    _, variables = small
    _, paths = clips
    by_path = batch_score.score_videos(port_model(), variables, list(paths), SIZE, CHUNK,
                                       num_slots=2)
    sources = {Path(p).stem: iter(frames_of(p)) for p in paths}
    by_frames = batch_score.score_videos(port_model(), variables, sources, SIZE, CHUNK,
                                         num_slots=2)
    for p in paths:
        np.testing.assert_array_equal(by_frames[Path(p).stem]["scores"], by_path[p]["scores"])


def test_failures_do_not_abort_the_batch(small, clips, tmp_path):
    jmodel, variables = small
    _, paths = clips
    garbage = tmp_path / "garbage.mp4"
    garbage.write_bytes(b"this is not a video")
    good = next(iter(paths))
    got = batch_score.score_videos(port_model(), variables, [str(garbage), good], SIZE, CHUNK,
                                   num_slots=2)
    want = jax_batch.score_videos(jmodel, variables, [str(garbage), good], SIZE, CHUNK,
                                  num_slots=2)
    # OpenCV yields no frame of the garbage file: 0 scores, as in JAX
    assert len(got[str(garbage)]["scores"]) == len(want[str(garbage)]["scores"]) == 0
    assert len(got[good]["scores"]) == paths[good]

    def broken():
        yield from frames_of(good)[:10]
        raise OSError("camera disconnected")

    progress = []
    got = batch_score.score_videos(port_model(), variables,
                                   {"broken": broken(), "good": good}, SIZE, CHUNK,
                                   num_slots=1, on_progress=lambda n, r: progress.append(n))
    assert got["broken"] == {"scores": None, "error": "camera disconnected"}
    np.testing.assert_allclose(got["good"]["scores"],
                               want[good]["scores"], **F32)
    assert sorted(progress) == ["broken", "good"]
    assert batch_score.score_videos(port_model(), variables, [], SIZE, CHUNK) == {}


def write_ckpt(path, variables, threshold=0.05):
    jax_save_checkpoint(path, {
        "model_type": "video", "params": variables["params"],
        "batch_stats": variables["batch_stats"], "epoch": 1,
        "args": {"image_size": SIZE, "sequence_length": CHUNK, **KW},
        "frame_score_threshold": threshold})
    return path


def test_score_video_dir_matches_jax(small, clips, tmp_path):
    _, variables = small
    root, paths = clips
    ckpt = write_ckpt(tmp_path / "best_model.ckpt", variables)
    got = batch_score.score_video_dir(str(ckpt), str(root), output_dir=str(tmp_path / "port"),
                                      num_slots=2, device="cpu")
    want = jax_batch.score_video_dir(str(ckpt), str(root), output_dir=str(tmp_path / "jax"),
                                     num_slots=2)
    written = json.loads((tmp_path / "port" / "batch_scores.json").read_text())
    assert written == got
    assert got.keys() == want.keys() and got["videos"].keys() == want["videos"].keys()
    assert got["frame_score_threshold"] == want["frame_score_threshold"] == 0.05
    for path, n_frames in paths.items():
        entry, jentry = got["videos"][path], want["videos"][path]
        assert entry.keys() == jentry.keys()
        assert entry["frames"] == jentry["frames"] == n_frames
        assert entry["anomalous_frames"] == jentry["anomalous_frames"]
        for k in ("mean_score", "max_score", "anomaly_ratio"):
            assert entry[k] == pytest.approx(jentry[k], rel=F32["rtol"], abs=F32["atol"])
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())
    with pytest.raises(FileNotFoundError):
        batch_score.score_video_dir(str(ckpt), str(tmp_path / "port"), device="cpu")


def test_cli_video_dir_and_video_modes(small, clips, tmp_path):
    jmodel, variables = small
    root, paths = clips
    ckpt = write_ckpt(tmp_path / "best_model.ckpt", variables, threshold=None)
    cli.main(["--checkpoint", str(ckpt), "--video-dir", str(root), "--device", "cpu"])
    summary = json.loads((tmp_path / "batch_scoring" / "batch_scores.json").read_text())
    assert summary["frame_score_threshold"] is None
    assert {p: v["frames"] for p, v in summary["videos"].items()} == paths
    assert "anomalous_frames" not in next(iter(summary["videos"].values()))

    clip = str(root / "c.mp4")
    out = tmp_path / "annotated.mp4"
    cli.main(["--checkpoint", str(ckpt), "--video", clip, "--output-video", str(out),
              "--device", "cpu"])
    assert (tmp_path / "score_timeline.png").exists()
    import cv2

    cap = cv2.VideoCapture(str(out))
    shape = (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
             int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
    cap.release()
    assert shape == (35, SIZE * 3, SIZE + 60)  # every frame written once: 3 panels + bar
    jout = tmp_path / "jax" / "annotated.mp4"
    jout.parent.mkdir()
    got = video_render.generate_video_output(load_flax_variables(port_model(), variables), None,
                                             clip, str(tmp_path / "again.mp4"), SIZE, CHUNK)
    want = jax_render.generate_video_output(jmodel, variables, clip, str(jout), SIZE, CHUNK)
    np.testing.assert_allclose(got, want, **F32)
