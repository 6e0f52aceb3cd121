"""The port's video evaluation against the JAX package's, on the CPU.

Streaming scores (both objectives, a ragged last chunk), the decode and
transfer stages, the generic and single-file video datasets, the dataset
evaluator (``results.txt``, AUROC, the PNGs, score modes), the
visualization helpers, metrics and plots, the refusals, and the trainer's
``training_history.png``.  A small model (latent and hidden 16, one
ConvLSTM layer, 32x32 frames) gets its weights from a seeded JAX init
with its norm statistics moved off identity; both packages read the same
``.ckpt`` or variables tree.  JAX runs its plain ``backend='xla'`` model.

Bar: f32 rtol 1e-4 / atol 1e-5 unless a test says otherwise.
"""

import shutil
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evaluate_video as jax_cli
from vad_tpu.data import video_dataset as jax_vds
from vad_tpu.data.synthetic import create_synthetic_video_data, create_synthetic_video_file
from vad_tpu.eval import metrics as jax_metrics
from vad_tpu.eval import plots as jax_plots
from vad_tpu.eval import video_eval as jax_eval
from vad_tpu.eval import video_render as jax_render
from vad_tpu.models.video_autoencoder import VideoAutoencoder as JaxVAE
from vad_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from vad_tpu_torch import evaluate_video as cli
from vad_tpu_torch.data import video_dataset as vds
from vad_tpu_torch.eval import metrics, plots, video_eval, video_render
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
from vad_tpu_torch.train.video_trainer import fit
from vad_tpu_torch.train_video import build_parser as train_parser
from vad_tpu_torch.utils.weights import load_flax_variables, state_dict_to_flax

F32 = dict(rtol=1e-4, atol=1e-5)
SIZE, CHUNK, HIDDEN = 32, 8, 16
ARGS = {"image_size": SIZE, "sequence_length": 4, "latent_dim": HIDDEN,
        "lstm_hidden_dim": HIDDEN, "lstm_layers": 1, "category": "S01"}


def jax_variables(seed=0):
    """A seeded JAX init with biases and norm statistics off identity."""
    jmodel = JaxVAE(latent_dim=HIDDEN, lstm_hidden_dim=HIDDEN, lstm_layers=1, backend="xla")
    init = jmodel.init(jax.random.key(seed), jnp.zeros((1, 2, SIZE, SIZE, 3)), train=False)
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if hasattr(tree, "items"):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        if name == "bias":
            return a + rng.normal(size=a.shape).astype(np.float32) * 0.05
        if name == "mean":
            return rng.normal(size=a.shape).astype(np.float32) * 0.05
        if name == "var":
            return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
        return a

    return jmodel, walk(init)


def port_model(variables):
    model = VideoAutoencoder(latent_dim=HIDDEN, lstm_hidden_dim=HIDDEN, lstm_layers=1,
                             device="cpu")
    return load_flax_variables(model, variables).eval()


def write_ckpt(path: Path, variables, objective="reconstruct", **extra) -> Path:
    jax_save_checkpoint(path, {
        "model_type": "video", "params": variables["params"],
        "batch_stats": variables["batch_stats"], "epoch": 3, "train_loss": 0.125,
        "args": {**ARGS, "objective": objective}, **extra})
    return path


@pytest.fixture(scope="module")
def small():
    return jax_variables(0)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """21 frames: two full chunks of 8 and a ragged one of 5."""
    path = tmp_path_factory.mktemp("clip") / "clip.mp4"
    return create_synthetic_video_file(str(path), n_frames=21, image_size=SIZE, seed=3,
                                       anomaly_range=(8, 14))


def decoded(path):
    """Every frame of an mp4 as RGB uint8 (what the decode stage reads)."""
    return [f for raw, n in video_render.iter_video_chunks(path, 1, SIZE) for f in raw[:n]]


# ------------------------------------------------------------ streaming


@pytest.mark.parametrize("objective", ["reconstruct", "predict"])
def test_stream_scores_matches_jax(small, clip, objective):
    jmodel, variables = small
    got_frames, want_frames = [], []
    got = video_render.stream_scores(port_model(variables), None, clip, SIZE, chunk=CHUNK,
                                     on_frame=lambda *a: got_frames.append(a),
                                     objective=objective)
    want = jax_render.stream_scores(jmodel, variables, clip, SIZE, chunk=CHUNK,
                                    on_frame=lambda *a: want_frames.append(a),
                                    objective=objective)
    assert got.shape == want.shape == (21,)
    np.testing.assert_allclose(got, want, **F32)
    assert len(got_frames) == len(want_frames) == 21
    for (o, r, e, s), (jo, jr, je, js) in zip(got_frames, want_frames):
        np.testing.assert_array_equal(o, jo)
        # the u8 reconstruction may round the other way where it sits on a boundary
        assert np.abs(r.astype(int) - jr.astype(int)).max() <= 1
        np.testing.assert_allclose(e, je, **F32)
        np.testing.assert_allclose(s, js, **F32)
    if objective == "predict":
        assert got[0] == got[1]  # frame 0 borrows frame 1's score


def test_stream_scores_from_frames_equals_from_path(small, clip):
    _, variables = small
    model = port_model(variables)
    from_path = video_render.stream_scores(model, None, clip, SIZE, chunk=CHUNK)
    from_frames = video_render.stream_scores(model, None, iter(decoded(clip)), SIZE, chunk=CHUNK)
    np.testing.assert_array_equal(from_path, from_frames)


def test_streaming_equals_full_sequence(small):
    """Chunked state-carrying inference == one full-sequence forward."""
    _, variables = small
    model = port_model(variables)
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 8, SIZE, SIZE, 3))
                         .astype(np.float32))
    with torch.no_grad():
        full = model.reconstruction_error(x, per_frame=True)
        states, chunks = model.zero_state(1, SIZE, SIZE), []
        for i in range(0, 8, 4):
            _, _, fs, states = model.stream_step(x[:, i:i + 4], states)
            chunks.append(fs)
    np.testing.assert_allclose(torch.cat(chunks, dim=1).numpy(), full.numpy(),
                               rtol=2e-4, atol=1e-6)


def test_decode_stage_matches_jax_and_pads_the_last_chunk(clip):
    got = list(video_render.iter_video_chunks(clip, CHUNK, SIZE))
    want = list(jax_render.iter_video_chunks(clip, CHUNK, SIZE))
    assert [n for _, n in got] == [n for _, n in want] == [8, 8, 5]
    for (raw, _), (jraw, _) in zip(got, want):
        np.testing.assert_array_equal(raw, jraw)
    last = got[-1][0]
    assert all(np.array_equal(last[t], last[4]) for t in range(5, 8))  # repeats its last frame
    # a frame source at another size is resized on the decode thread
    big = [np.kron(f, np.ones((2, 2, 1), np.uint8)) for f in decoded(clip)]
    (raw, n), *_ = video_render.iter_video_chunks(iter(big), CHUNK, SIZE)
    assert raw.shape == (CHUNK, SIZE, SIZE, 3) and n == CHUNK


def test_transfer_stage_on_the_cpu_copies_and_keeps_order(clip):
    chunks = list(video_render.iter_device_chunks(clip, CHUNK, SIZE, "cpu"))
    assert [n for _, _, n in chunks] == [8, 8, 5]
    for raw, dev, _ in chunks:
        assert dev.shape == (1, CHUNK, SIZE, SIZE, 3) and dev.dtype == torch.uint8
        np.testing.assert_array_equal(dev[0].numpy(), raw)
        assert dev.numpy().ctypes.data != raw.ctypes.data  # a copy, not a view


def test_source_errors_reach_the_consumer_and_threads_stop():
    def failing():
        yield np.zeros((SIZE, SIZE, 3), np.uint8)
        raise OSError("disk went away")

    with pytest.raises(OSError, match="disk went away"):
        list(video_render.iter_device_chunks(failing(), 1, SIZE, "cpu"))

    before = threading.active_count()
    endless = (np.zeros((SIZE, SIZE, 3), np.uint8) for _ in iter(int, 1))
    chunks = video_render.iter_device_chunks(endless, 2, SIZE, "cpu")
    next(chunks)
    chunks.close()  # the consumer stops: both stages end
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


# -------------------------------------------------------------- datasets


@pytest.fixture(scope="module")
def mp4_layout(tmp_path_factory):
    """The generic layout: mp4 files in good/ and bad/ folders, plus a
    frame folder."""
    root = tmp_path_factory.mktemp("generic")
    for split, folder, n, seed, anomaly in (("train", "good", 12, 0, None),
                                            ("test", "good", 9, 1, None),
                                            ("test", "bad", 13, 2, (4, 9))):
        d = root / "cat" / split / folder
        d.mkdir(parents=True, exist_ok=True)
        create_synthetic_video_file(str(d / f"v{seed}.mp4"), n_frames=n, image_size=SIZE,
                                    seed=seed, anomaly_range=anomaly)
    from PIL import Image

    frames_dir = root / "cat" / "test" / "bad" / "frames7"
    frames_dir.mkdir()
    rng = np.random.default_rng(7)
    for t in range(6):
        Image.fromarray(rng.integers(0, 256, (SIZE + 8, SIZE + 8, 3), dtype=np.uint8)).save(
            frames_dir / f"{t:03d}.png")
    return str(root)


@pytest.mark.parametrize("cache_frames", [True, False])
@pytest.mark.parametrize("split", ["train", "test"])
def test_video_dataset_matches_jax(mp4_layout, split, cache_frames):
    assert vds.detect_video_dataset_class(mp4_layout, "cat") is vds.VideoDataset
    kw = dict(sequence_length=4, stride=2, image_size=SIZE, cache_frames=cache_frames)
    got = vds.VideoDataset(mp4_layout, "cat", split, **kw)
    want = jax_vds.VideoDataset(mp4_layout, "cat", split, **kw)
    assert len(got) == len(want) > 0
    assert [(w.source, w.start, w.label, w.label_name, w.video_id) for w in got.windows] == [
        (w.source, w.start, w.label, w.label_name, w.video_id) for w in want.windows]
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.has_frame_labels == want.has_frame_labels
    for i in range(len(got)):
        a, b = got[i], want[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    raw = vds.VideoDataset(mp4_layout, "cat", split, normalize=False, **kw)[0]["frames"]
    assert raw.dtype == np.uint8
    np.testing.assert_array_equal(raw.astype(np.float32) / 127.5 - 1.0, got[0]["frames"])
    got.close()
    assert got._caps.open_handles() == 0


def test_get_video_dataloaders_gives_the_u8_windows(mp4_layout):
    """The factories give JAX's batches: host numpy dicts of normalized f32
    windows, the train split shuffled with seed 0 (two epochs), the test
    split in order, the partial tail kept."""
    kw = dict(sequence_length=4, stride=2, image_size=SIZE, batch_size=3, num_workers=1)
    got = vds.get_video_dataloaders(mp4_layout, "cat", **kw)
    want = jax_vds.get_video_dataloaders(mp4_layout, "cat", **kw)
    for loader, ref in zip(got, want):
        assert (len(loader), loader.shuffle) == (len(ref), ref.shuffle)
        for _ in range(2):
            batches, ref_batches = list(loader), list(ref)
            assert len(batches) == len(ref_batches) == len(loader)
            for a, b in zip(batches, ref_batches):
                assert a.keys() == b.keys()
                assert a["frames"].dtype == np.float32 and type(a["frames"]) is np.ndarray
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
    sizes = [len(b["frames"]) for b in got[1]]
    assert sum(sizes) == len(got[1].dataset) and sizes[-1] <= 3


def test_video_file_dataset_matches_jax(clip):
    got = vds.VideoFileDataset(clip, sequence_length=4, stride=3, image_size=SIZE)
    want = jax_vds.VideoFileDataset(clip, sequence_length=4, stride=3, image_size=SIZE)
    assert (got.total_frames, got.fps, got.width, got.height) == (
        want.total_frames, want.fps, want.width, want.height)
    assert len(got) == len(want) == 6
    for i in (0, 1, 5, 2):  # sequential reads, then a seek back
        a, b = got[i], want[i]
        assert a.keys() == b.keys() == {"frames", "start_frame", "original_frames"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    plain = vds.VideoFileDataset(clip, sequence_length=4, image_size=16, return_original=False)
    sample = plain[0]
    assert "original_frames" not in sample and sample["frames"].shape == (4, 16, 16, 3)


def test_capture_cache_seeks_only_out_of_order_and_bounds_handles(clip, tmp_path):
    cache = vds._CaptureCache(max_per_thread=2)
    whole = decoded(clip)
    first, second = cache.read_window(clip, 0, 5), cache.read_window(clip, 5, 5)
    back = cache.read_window(clip, 2, 3)
    np.testing.assert_array_equal(np.stack(first + second), np.stack(whole[:10]))
    np.testing.assert_array_equal(np.stack(back), np.stack(whole[2:5]))
    tail = cache.read_window(clip, 19, 5)  # past the end: padded with the last frame
    np.testing.assert_array_equal(np.stack(tail), np.stack(whole[19:] + [whole[-1]] * 3))
    others = [shutil.copy(clip, tmp_path / f"c{i}.mp4") for i in range(2)]
    for p in others:
        cache.read_window(str(p), 0, 1)
    assert cache.open_handles() == 2  # the oldest handle was released
    with pytest.raises(RuntimeError, match="could not decode any frame"):
        cache.read_window(clip, 40, 2)
    cache.close()
    assert cache.open_handles() == 0


def test_normalize_frame_matches_jax(clip):
    frame = decoded(clip)[3]
    for size in (SIZE, 24):
        np.testing.assert_array_equal(vds._normalize_frame(frame, size),
                                      jax_vds._normalize_frame(frame, size))


# ------------------------------------------------------------- evaluate


@pytest.fixture(scope="module")
def ipad_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ipad")
    create_synthetic_video_data(str(root), "S01", n_train_videos=1, n_test_videos=2,
                                frames_per_video=16, image_size=SIZE)
    return str(root)


def run_both(small, tmp_path, data_dir, category, objective, flags):
    """The JAX evaluator and the port's on copies of one checkpoint:
    (port AUROC, JAX AUROC, port eval dir, JAX eval dir)."""
    _, variables = small
    out = {}
    for side in ("port", "jax"):
        ckpt = write_ckpt(tmp_path / side / "best_model.ckpt", variables, objective)
        argv = ["--checkpoint", str(ckpt), "--data-dir", data_dir, "--category", category,
                "--batch-size", "3", *flags]
        if side == "port":
            out[side] = video_eval.evaluate(cli.build_parser().parse_args(argv + ["--device",
                                                                                  "cpu"]))
        else:
            out[side] = jax_eval.evaluate(jax_cli.build_parser().parse_args(argv))
    return (out["port"], out["jax"], tmp_path / "port" / "evaluation",
            tmp_path / "jax" / "evaluation")


def assert_same_results(got_dir: Path, want_dir: Path):
    got = (got_dir / "results.txt").read_text().splitlines()
    want = (want_dir / "results.txt").read_text().splitlines()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        head_a, _, num_a = a.rpartition(": ")
        head_b, _, num_b = b.rpartition(": ")
        assert head_a == head_b
        try:
            va, vb = float(num_a.rstrip("x")), float(num_b.rstrip("x"))
        except ValueError:
            assert a == b
            continue
        assert va == pytest.approx(vb, rel=1e-4, abs=1e-6), (a, b)
    assert sorted(p.name for p in got_dir.iterdir()) == sorted(p.name for p in want_dir.iterdir())


@pytest.mark.parametrize("objective,flags", [
    ("reconstruct", []),
    ("reconstruct", ["--score-mode", "max"]),
    ("reconstruct", ["--score-mode", "p99", "--score-smooth", "1.5"]),
    ("predict", ["--score-smooth", "1.0"]),
], ids=["mean", "max", "p99-smooth", "predict-smooth"])
def test_evaluate_ipad_matches_jax(small, ipad_root, tmp_path, objective, flags):
    got, want, got_dir, want_dir = run_both(small, tmp_path, ipad_root, "S01", objective, flags)
    assert round(got, 4) == round(want, 4)
    assert_same_results(got_dir, want_dir)
    names = {p.name for p in got_dir.iterdir()}
    assert {"results.txt", "roc_curve.png", "score_distribution.png"} <= names
    assert any(n.startswith("visualization_") for n in names)
    assert "Frame-level AUROC" in (got_dir / "results.txt").read_text()


def test_evaluate_latent_scorer_matches_jax(small, ipad_root, tmp_path):
    """``--scorer latent`` from one ``--latent-stats`` npz (the JAX
    evaluator's own fit): the same AUROC to 4 decimals, the results within
    the f32 bar, the ``Scorer: latent`` line and the latent heatmaps."""
    _, variables = small
    fit_ckpt = write_ckpt(tmp_path / "fit" / "best_model.ckpt", variables)
    jax_eval.evaluate(jax_cli.build_parser().parse_args(
        ["--checkpoint", str(fit_ckpt), "--data-dir", ipad_root, "--category", "S01",
         "--batch-size", "3", "--scorer", "latent", "--latent-proj-dim", "24"]))
    npz = fit_ckpt.parent / "evaluation" / "latent_stats.npz"
    got, want, got_dir, want_dir = run_both(small, tmp_path, ipad_root, "S01", "reconstruct",
                                            ["--scorer", "latent", "--latent-stats", str(npz)])
    assert round(got, 4) == round(want, 4)
    assert_same_results(got_dir, want_dir)
    text = (got_dir / "results.txt").read_text()
    assert "Scorer: latent" in text and "Frame-level AUROC" in text


def test_evaluate_generic_mp4_matches_jax(small, mp4_layout, tmp_path):
    got, want, got_dir, want_dir = run_both(small, tmp_path, mp4_layout, "cat", "reconstruct",
                                            [])
    assert round(got, 4) == round(want, 4)
    assert_same_results(got_dir, want_dir)


def test_score_windows_takes_any_dataset_object(small, ipad_root):
    """The scoring loop over an in-memory object with the dataset
    interface: per-window scores equal the JAX model's."""
    jmodel, variables = small
    ds = vds.IPADDataset(ipad_root, "S01", "test", sequence_length=4, stride=4,
                         image_size=SIZE, normalize=False)

    class InMemory:
        labels, has_frame_labels = ds.labels, True

        def __len__(self):
            return len(ds)

        def __getitem__(self, i):
            return ds[i]

    got = video_eval.score_windows(port_model(variables), InMemory(), batch_size=3)
    x = jnp.asarray(np.stack([ds[i]["frames"] for i in range(len(ds))]).astype(np.float32)
                    / 127.5 - 1.0)
    seq = jmodel.apply(variables, x, method=JaxVAE.reconstruction_error)
    frame = jmodel.apply(variables, x, per_frame=True, method=JaxVAE.reconstruction_error)
    np.testing.assert_allclose(got["sequence"], np.asarray(seq), **F32)
    np.testing.assert_allclose(got["frame"], np.asarray(frame), **F32)
    np.testing.assert_array_equal(got["labels"], ds.labels)
    assert got["frame_labels"].shape == got["frame"].shape


def test_load_video_model_reads_both_packages_checkpoints(small, tmp_path):
    _, variables = small
    jax_ckpt = write_ckpt(tmp_path / "jax.ckpt", variables)
    model, loaded, saved = video_eval.load_video_model(jax_ckpt, "cpu")
    assert not model.training and saved["lstm_layers"] == 1
    from vad_tpu_torch.utils.checkpoint import save_checkpoint

    port_ckpt = tmp_path / "port.ckpt"
    save_checkpoint(port_ckpt, {**state_dict_to_flax(model), "args": ARGS, "epoch": 1})
    again, _, _ = video_eval.load_video_model(port_ckpt, "cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k


def test_refusals():
    base = ["--checkpoint", "x.ckpt", "--device", "cpu"]
    # --data-parallel is ported (item 10): it gets as far as reading the checkpoint
    with pytest.raises(FileNotFoundError, match="x.ckpt"):
        video_eval.evaluate(cli.build_parser().parse_args(base + ["--data-parallel"]))
    args = cli.build_parser().parse_args(base + ["--latent-proj-dim", "64", "--latent-grid", "8",
                                                 "--latent-stats", "s.npz"])
    assert (args.latent_proj_dim, args.latent_grid, args.latent_stats) == (64, 8, "s.npz")
    for mode in (["--video", "v.mp4"], ["--video-dir", "d"]):
        with pytest.raises(SystemExit, match="supports dataset evaluation only"):
            cli.main(base + ["--scorer", "latent", *mode])


def test_parser_has_the_jax_flags_and_device():
    ours = {a.dest: a.default for a in cli.build_parser()._actions}
    theirs = {a.dest: a.default for a in jax_cli.build_parser()._actions}
    assert ours.pop("device") == "cuda"
    assert ours == theirs


# -------------------------------------------------- pure numpy and cv2


def test_heatmap_and_annotated_frame_equal_jax():
    rng = np.random.default_rng(5)
    err = rng.random((SIZE, SIZE)).astype(np.float32)
    for size in (None, (48, 40)):
        np.testing.assert_array_equal(video_eval.create_heatmap(err, size),
                                      jax_eval.create_heatmap(err, size))
    orig = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    recon = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)
    for score in (0.001, 0.006, 0.009, 0.5):  # green, orange, red, clipped
        np.testing.assert_array_equal(
            video_render.compose_annotated_frame(orig, recon, err, score),
            jax_render.compose_annotated_frame(orig, recon, err, score))


def test_score_helpers_equal_jax():
    rng = np.random.default_rng(6)
    f = rng.random((5, 12))
    for sigma in (0.5, 1.0, 2.5):
        np.testing.assert_array_equal(video_eval.smooth_frame_scores(f, sigma),
                                      jax_eval.smooth_frame_scores(f, sigma))
    for mode in video_eval.SCORE_MODES:
        for smooth in (0.0, 1.5):
            np.testing.assert_array_equal(video_eval.aggregate_sequence_scores(f, mode, smooth),
                                          jax_eval.aggregate_sequence_scores(f, mode, smooth))
    with pytest.raises(ValueError, match="score_mode"):
        video_eval.aggregate_sequence_scores(f, "median")
    x = rng.uniform(-1.2, 1.2, (4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(video_eval.denormalize_u8(x), jax_eval.denormalize_u8(x))


@pytest.mark.parametrize("sklearn", [True, False], ids=["sklearn", "numpy"])
def test_metrics_equal_jax(monkeypatch, sklearn):
    if not sklearn:
        for mod in (metrics, jax_metrics):
            for name in ("_sk_ap", "_sk_auroc", "_sk_roc_curve"):
                monkeypatch.setattr(mod, name, None)
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 2, 60)
    scores = np.round(rng.random(60), 1)  # ties
    for fn in ("auroc", "average_precision"):
        assert getattr(metrics, fn)(labels, scores) == getattr(jax_metrics, fn)(labels, scores)
    for a, b in zip(metrics.roc_points(labels, scores), jax_metrics.roc_points(labels, scores)):
        np.testing.assert_array_equal(a, b)
    masks = np.zeros((3, 16, 16))
    masks[0, 2:6, 2:6] = masks[1, 9:14, 3:5] = 1
    maps = rng.random((3, 16, 16)) + masks * 0.5
    assert metrics.aupro(masks, maps) == jax_metrics.aupro(masks, maps)
    assert np.isnan(metrics.aupro(np.zeros((1, 4, 4)), maps[:1, :4, :4]))
    assert metrics.calibrate_threshold(scores) == jax_metrics.calibrate_threshold(scores)
    assert metrics.calibrate_threshold([]) is None
    for ckpt in ({"frame_score_threshold": 0.2, "score_baseline": {"p50": 1}},
                 {"frame_score_threshold": 0.2, "args": {"objective": "predict"},
                  "score_baseline": {"p50": 1}},
                 {"model_type": "image", "args": {"objective": "predict"},
                  "score_baseline": {"p50": 1}}):
        assert metrics.serving_frame_threshold(ckpt) == jax_metrics.serving_frame_threshold(ckpt)
        assert metrics.serving_score_baseline(ckpt) == jax_metrics.serving_score_baseline(ckpt)
    for n, a in (([1.0, 2.0], [3.0]), ([], [1.0]), ([1.0], []), ([0.0], [1.0])):
        assert metrics.separation_ratio(n, a) == jax_metrics.separation_ratio(n, a)
    defects = [["good", "scratch", "dent"][i % 3] for i in range(60)]
    assert metrics.per_defect_breakdown(labels, scores, defects) == \
        jax_metrics.per_defect_breakdown(labels, scores, defects)


def test_plots_draw_what_jax_draws(tmp_path):
    import matplotlib.image as mpimg

    rng = np.random.default_rng(8)
    labels, scores = np.array([0, 0, 1, 1, 0, 1]), rng.random(6)
    rows = [{"image": rng.uniform(-1, 1, (8, 8, 3)), "recon": rng.uniform(-1, 1, (8, 8, 3)),
             "error": rng.random((8, 8)), "mask": rng.random((8, 8)) > 0.5,
             "defect_type": "dent"}]
    history = {"train_loss": [1.0, 0.5], "val_loss": [1.1, 0.6], "normal_err": [0.1, 0.1],
               "anomaly_err": [0.2, 0.3]}
    calls = [("roc_curve", (labels, scores), {}),
             ("score_distribution", (labels, scores), {"count_in_label": False}),
             ("reconstruction_grid", (rows,), {}),
             ("training_history", (history,), {})]
    for name, args, kw in calls:
        getattr(plots, f"plot_{name}")(*args, tmp_path / f"port_{name}.png", **kw)
        getattr(jax_plots, f"plot_{name}")(*args, tmp_path / f"jax_{name}.png", **kw)
        np.testing.assert_array_equal(mpimg.imread(tmp_path / f"port_{name}.png"),
                                      mpimg.imread(tmp_path / f"jax_{name}.png"))
    np.testing.assert_array_equal(plots.denormalize(rows[0]["image"]),
                                  jax_plots.denormalize(rows[0]["image"]))
    plots.plot_reconstruction_grid([], tmp_path / "none.png")
    assert not (tmp_path / "none.png").exists()


def test_plot_or_skip_skips_only_a_missing_matplotlib(monkeypatch, tmp_path, capsys):
    path = tmp_path / "t.png"
    assert plots.plot_or_skip(plots.plot_score_timeline, [0.1, 0.2], path, threshold=0.15)
    assert path.exists()

    def missing():
        raise plots.MatplotlibMissing("matplotlib is not installed")

    monkeypatch.setattr(plots, "pyplot", missing)
    assert not plots.plot_or_skip(plots.plot_score_timeline, [0.1], tmp_path / "u.png")
    skipped = capsys.readouterr().out.strip()
    assert skipped == f"Skipped {tmp_path / 'u.png'}: matplotlib is not installed"
    with pytest.raises(ZeroDivisionError):
        plots.plot_or_skip(lambda p: 1 / 0, tmp_path / "v.png")


# --------------------------------------------------------------- trainer


class Windows:
    """Tiny in-memory windows with the IPAD dataset's sample dicts."""

    def __init__(self, labels, seed):
        self.labels = np.asarray(labels, np.int64)
        rng = np.random.default_rng(seed)
        self.frames = rng.integers(0, 256, (len(labels), 2, SIZE, SIZE, 3), dtype=np.uint8)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return {"frames": self.frames[i], "label": self.labels[i],
                "frame_labels": np.full(2, self.labels[i], np.int64)}


@pytest.mark.parametrize("matplotlib_present", [True, False], ids=["drawn", "skipped"])
def test_fit_writes_training_history(monkeypatch, tmp_path, capsys, matplotlib_present):
    if not matplotlib_present:
        def missing():
            raise plots.MatplotlibMissing("matplotlib is not installed")

        monkeypatch.setattr(plots, "pyplot", missing)
    args = train_parser().parse_args([
        "--category", "t", "--epochs", "1", "--batch-size", "2", "--sequence-length", "2",
        "--image-size", str(SIZE), "--latent-dim", "8", "--lstm-hidden-dim", "8",
        "--lstm-layers", "1", "--num-workers", "0", "--results-dir", str(tmp_path)])
    run_dir = Path(fit(args, Windows([0, 0], 1), Windows([0, 1], 2), "cpu")["results_dir"])
    png = run_dir / "training_history.png"
    assert png.exists() == matplotlib_present
    assert (f"Skipped {png}: matplotlib is not installed" in capsys.readouterr().out) != \
        matplotlib_present
    assert (run_dir / "final_model.ckpt").exists()


def test_visualizations_need_no_jax_shapes(small, ipad_root, tmp_path):
    """generate_visualizations on uint8 windows writes one PNG per picked
    window, named as the JAX evaluator names them."""
    _, variables = small
    ds = vds.IPADDataset(ipad_root, "S01", "test", sequence_length=4, stride=4,
                         image_size=SIZE, normalize=False)
    video_eval.generate_visualizations(port_model(variables), ds, tmp_path, num_samples=4,
                                       objective="predict")
    names = sorted(p.name for p in tmp_path.iterdir())
    normal = [i for i, lab in enumerate(ds.labels) if lab == 0][:2]
    anomaly = [i for i, lab in enumerate(ds.labels) if lab == 1][:2]
    assert names == sorted([f"visualization_{i}_normal.png" for i in normal]
                           + [f"visualization_{i}_anomaly.png" for i in anomaly])
