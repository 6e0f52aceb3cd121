"""The port's image pipeline against the JAX package's, on the CPU: the
synthetic fixtures and the MVTec dataset, the evaluator's pieces
(smoothing, score modes, localization, ``results.txt``), the two CLIs
end to end (``python -m vad_tpu_torch.train`` then ``... evaluate`` with
both scorers, in-process through ``main``, against the JAX evaluator on
the same checkpoint), resuming, the campaign, the parsers and the
refusals.

Small sizes: 32 px images, latent 16; the evaluator's checkpoint holds a
seeded JAX init with biases, scales and statistics moved off identity.
Bar: f32 rtol 1e-4 / atol 1e-5 unless a test says otherwise.
"""

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evaluate as jax_eval_cli
import train as jax_train_cli
from tests.test_torch_training import perturbed
from vad_tpu import campaign as jax_campaign
from vad_tpu.data import image_dataset as jax_ids
from vad_tpu.data import synthetic as jax_synthetic
from vad_tpu.eval import image_eval as jax_eval
from vad_tpu.models.autoencoder import ConvAutoencoder as JaxAE
from vad_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from vad_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from vad_tpu_torch import campaign
from vad_tpu_torch import evaluate as eval_cli
from vad_tpu_torch.data import image_dataset as ids
from vad_tpu_torch.data import synthetic
from vad_tpu_torch.eval import image_eval
from vad_tpu_torch.train import __main__ as train_cli

F32 = dict(rtol=1e-4, atol=1e-5)
SIZE, LATENT = 32, 16
ARGS = {"image_size": SIZE, "latent_dim": LATENT, "category": "synthetic"}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mvtec")
    synthetic.create_synthetic_image_data(str(root), "synthetic", n_train=8, n_test_good=4,
                                          n_test_defect=6, image_size=SIZE)
    return root


@pytest.fixture(scope="module")
def variables():
    jmodel = JaxAE(latent_dim=LATENT)
    init = jmodel.init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False)
    return perturbed(init, np.random.default_rng(1))


def write_ckpt(path: Path, variables, data_root) -> Path:
    jax_save_checkpoint(path, {"params": variables["params"],
                               "batch_stats": variables["batch_stats"], "epoch": 3,
                               "train_loss": 0.25, "model_type": "image",
                               "args": {**ARGS, "data_dir": str(data_root)}})
    return path


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("kind", ["circle", "textured"])
def test_synthetic_pngs_equal_jax(kind, tmp_path):
    make = {"circle": "create_synthetic_image_data",
            "textured": "create_synthetic_textured_data"}[kind]
    kw = dict(n_train=3, n_test_good=2, n_test_defect=4, image_size=48)
    getattr(synthetic, make)(str(tmp_path / "port"), "cat", **kw)
    getattr(jax_synthetic, make)(str(tmp_path / "jax"), "cat", **kw)
    files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.png"))
    assert len(files) == 3 + 2 + 4 + 4
    assert files == sorted(p.relative_to(tmp_path / "jax")
                           for p in (tmp_path / "jax").rglob("*.png"))
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


@pytest.mark.parametrize("normalize", [True, False])
def test_mvtec_dataset_matches_jax(data_root, normalize):
    for split in ("train", "test"):
        ours = ids.MVTecDataset(str(data_root), "synthetic", split, SIZE, normalize=normalize)
        theirs = jax_ids.MVTecDataset(str(data_root), "synthetic", split, SIZE,
                                      normalize=normalize)
        assert len(ours) == len(theirs) and ours.defect_types == theirs.defect_types
        np.testing.assert_array_equal(ours.labels, theirs.labels)
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))
    with pytest.raises(ValueError, match="Category folder not found"):
        ids.MVTecDataset(str(data_root), "nope")


def test_get_dataloaders_gives_u8_image_batches(data_root):
    """The factories give JAX's batches: host numpy dicts of normalized f32
    images, the train split shuffled with seed 0 (two epochs), the test
    split in order, the tail of 2 kept."""
    kw = dict(batch_size=3, image_size=SIZE, num_workers=0)
    got = ids.get_dataloaders(str(data_root), "synthetic", **kw)
    want = jax_ids.get_dataloaders(str(data_root), "synthetic", **kw)
    train, test = got
    assert train.shuffle and not test.shuffle
    for loader, ref in zip(got, want):
        for _ in range(2):
            batches, ref_batches = list(loader), list(ref)
            assert len(batches) == len(ref_batches)
            for a, b in zip(batches, ref_batches):
                assert a.keys() == b.keys()
                for key in a:
                    if isinstance(a[key], list):
                        assert a[key] == b[key]
                    else:
                        np.testing.assert_array_equal(a[key], b[key])
    batches = list(train)
    assert [len(b["image"]) for b in batches] == [3, 3, 2]
    assert batches[0]["image"].dtype == np.float32 and batches[0]["image"].shape == (3, SIZE,
                                                                                    SIZE, 3)
    assert isinstance(batches[0]["defect_type"], list) and batches[0]["mask"].shape == (3, SIZE,
                                                                                       SIZE)
    labels = np.concatenate([b["label"] for b in test])
    np.testing.assert_array_equal(labels, [1] * 6 + [0] * 4)  # defect/ sorts before good/


# ------------------------------------------------------------- evaluator


@pytest.mark.parametrize("sigma", [0.6, 1.0, 2.5])
def test_smooth_error_map_matches_jax(sigma):
    err = np.random.default_rng(0).random((2, 13, 17)).astype(np.float32)
    got = image_eval.smooth_error_map(torch.from_numpy(err), sigma).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jax_eval.smooth_error_map(jnp.asarray(err), sigma)), **F32)


@pytest.mark.parametrize("mode,smooth", [("mean", 0.0), ("max", 0.0), ("p99", 0.0),
                                         ("max", 4.0)])
def test_compute_scores_match_jax(variables, data_root, tmp_path, mode, smooth):
    ckpt = write_ckpt(tmp_path / "best_model.ckpt", variables, data_root)
    model, _, _ = image_eval.load_image_model(ckpt, "cpu")
    jmodel, jvars, _ = jax_eval.load_image_model(ckpt)
    port_ds = ids.MVTecDataset(str(data_root), "synthetic", "test", SIZE, normalize=False)
    jax_ds = jax_ids.MVTecDataset(str(data_root), "synthetic", "test", SIZE)
    labels, scores, defects = image_eval.compute_scores(model, port_ds, batch_size=4,
                                                        score_mode=mode, score_smooth=smooth)
    jl, js, jd = jax_eval.compute_scores(jmodel, jvars, jax_ds, batch_size=4, score_mode=mode,
                                         score_smooth=smooth)
    np.testing.assert_array_equal(labels, jl)
    assert list(defects) == list(jd)
    np.testing.assert_allclose(scores, js, **F32)


@pytest.mark.parametrize("smooth", [0.0, 1.5])
def test_compute_localization_matches_jax(variables, data_root, tmp_path, smooth):
    ckpt = write_ckpt(tmp_path / "best_model.ckpt", variables, data_root)
    model, _, _ = image_eval.load_image_model(ckpt, "cpu")
    jmodel, jvars, _ = jax_eval.load_image_model(ckpt)
    got = image_eval.compute_localization(
        model, ids.MVTecDataset(str(data_root), "synthetic", "test", SIZE, normalize=False),
        batch_size=4, score_smooth=smooth)
    want = jax_eval.compute_localization(
        jmodel, jvars, jax_ids.MVTecDataset(str(data_root), "synthetic", "test", SIZE),
        batch_size=4, score_smooth=smooth)
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=1e-4), key


@pytest.mark.parametrize("extra", [
    dict(),
    dict(pixel_score=0.91234, aupro_score=0.85, ap_score=0.77777),
    dict(pixel_score=float("nan"), aupro_score=0.5, scorer="latent", ap_score=0.5),
], ids=["reference-lines", "all-metrics", "latent-nan-pixel"])
def test_results_txt_is_byte_equal_to_jax(tmp_path, extra):
    breakdown = {"good": {"count": 4, "mean_score": 0.012345, "is_anomaly": 0},
                 "defect": {"count": 6, "mean_score": 0.0456, "is_anomaly": 1},
                 "crack": {"count": 2, "mean_score": 1.5, "is_anomaly": 1}}
    image_eval.write_results_txt(tmp_path / "port.txt", 0.87654, breakdown, **extra)
    jax_eval.write_results_txt(tmp_path / "jax.txt", 0.87654, breakdown, **extra)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


# ------------------------------------------------------------------ CLIs


def train_argv(data_root, results, *extra):
    return ["--device", "cpu", "--category", "synthetic", "--data-dir", str(data_root),
            "--image-size", str(SIZE), "--latent-dim", str(LATENT), "--batch-size", "4",
            "--num-workers", "2", "--results-dir", str(results), *extra]


@pytest.fixture(scope="module")
def trained(data_root, tmp_path_factory):
    """``python -m vad_tpu_torch.train`` for 2 epochs (8 images, batch 4),
    in-process."""
    results = tmp_path_factory.mktemp("results")
    out = train_cli.main(train_argv(data_root, results, "--epochs", "2", "--seed", "3"))
    return out["results_dir"]


def test_training_writes_the_jax_trainers_files(trained):
    names = {p.name for p in trained.iterdir()}
    assert {"best_model.ckpt", "final_model.ckpt", "metrics.jsonl"} <= names
    ckpt = jax_load_checkpoint(trained / "best_model.ckpt")  # the JAX reader takes it
    assert ckpt["model_type"] == "image" and ckpt["args"]["latent_dim"] == LATENT
    assert ckpt["threshold_method"] == "p99 of validation normal scores"
    assert ckpt["score_threshold"] > 0 and ckpt["score_baseline"]["count"] == 4
    assert len(ckpt["history"]["val_loss"]) == ckpt["epoch"]
    final = jax_load_checkpoint(trained / "final_model.ckpt")
    assert final["epoch"] == 2 and len(final["history"]["train_loss"]) == 2
    assert "torch_opt_state" in final and "opt_state" not in final


def copy_run(trained, dest: Path) -> Path:
    dest.mkdir(parents=True)
    shutil.copy(trained / "best_model.ckpt", dest / "best_model.ckpt")
    return dest / "best_model.ckpt"


def assert_same_results(got: Path, want: Path):
    """Same lines; the numbers within the f32 bar."""
    got, want = got.read_text().splitlines(), want.read_text().splitlines()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        head_a, num_a = a.rsplit("=", 1) if "mean_score=" in a else a.rpartition(": ")[::2]
        head_b, num_b = b.rsplit("=", 1) if "mean_score=" in b else b.rpartition(": ")[::2]
        assert head_a == head_b
        try:
            va, vb = float(num_a), float(num_b)
        except ValueError:
            assert a == b
            continue
        assert va == pytest.approx(vb, rel=1e-4, abs=1e-4), (a, b)


@pytest.mark.parametrize("flags", [[], ["--score-mode", "max", "--score-smooth", "1.5"],
                                   ["--scorer", "latent", "--latent-proj-dim", "24"]],
                         ids=["recon", "recon-max-smooth", "latent"])
def test_evaluate_cli_matches_jax(trained, tmp_path, capsys, flags):
    """The port's ``evaluate`` main and the JAX evaluator on copies of the
    port-trained checkpoint: the same AUROC to 4 decimals, ``results.txt``
    the same lines with the numbers within the f32 bar, the same files.
    With ``--scorer latent`` the port fits and writes
    ``latent_stats.npz``, and the JAX evaluator reads that file."""
    port_ckpt = copy_run(trained, tmp_path / "port")
    jax_ckpt = copy_run(trained, tmp_path / "jax")
    got = eval_cli.main(["--checkpoint", str(port_ckpt), "--device", "cpu", *flags])
    out = capsys.readouterr().out
    assert f"AUROC: {got:.4f}" in out
    jax_flags = list(flags)
    if "latent" in flags:
        npz = tmp_path / "port" / "evaluation" / "latent_stats.npz"
        assert "fit on 8 images" in out and npz.exists()
        jax_flags += ["--latent-stats", str(npz)]
    want = jax_eval.evaluate(jax_eval_cli.build_parser().parse_args(
        ["--checkpoint", str(jax_ckpt), *jax_flags]))
    assert round(got, 4) == round(want, 4)
    port_dir, jax_dir = tmp_path / "port" / "evaluation", tmp_path / "jax" / "evaluation"
    assert_same_results(port_dir / "results.txt", jax_dir / "results.txt")
    assert ({p.name for p in port_dir.iterdir()} - {"latent_stats.npz"}
            == {p.name for p in jax_dir.iterdir()})
    if "latent" in flags:  # a second run reads the stats instead of fitting
        again = eval_cli.main(["--checkpoint", str(port_ckpt), "--device", "cpu", *flags,
                               "--latent-stats", str(npz)])
        assert again == got and "loaded latent stats" in capsys.readouterr().out


def test_resume_own_and_jax_checkpoints(trained, data_root, tmp_path, capsys):
    run = tmp_path / "run"
    shutil.copytree(trained, run)
    out = train_cli.main(train_argv(data_root, tmp_path, "--epochs", "3", "--resume",
                                    str(run / "final_model.ckpt")))
    text = capsys.readouterr().out
    assert "Resumed from" in text and "at epoch 3" in text and "Adam moments restart" not in text
    assert out["results_dir"] == run and len(out["history"]["train_loss"]) == 3
    jax_ckpt = tmp_path / "jax" / "model.ckpt"
    ckpt = jax_load_checkpoint(run / "best_model.ckpt")
    jax_save_checkpoint(jax_ckpt, {k: v for k, v in ckpt.items() if k != "torch_opt_state"})
    train_cli.main(train_argv(data_root, tmp_path, "--epochs", str(ckpt["epoch"] + 1),
                              "--resume", str(jax_ckpt)))
    assert "Adam moments restart" in capsys.readouterr().out


# -------------------------------------------------------------- campaign


def test_campaign_discovery_matches_jax(tmp_path):
    for name in ("catB", "catA", "bottle", "bottle_cap"):
        (tmp_path / "data" / name / "train" / "good").mkdir(parents=True)
    (tmp_path / "data" / "no_split").mkdir()
    for run in ("bottle_20250101_000000", "bottle_20250301_000000",
                "bottle_cap_20250901_000000", "video_S01_20250401_000000", "catA_2025"):
        (tmp_path / "res" / run).mkdir(parents=True)
        (tmp_path / "res" / run / "best_model.ckpt").write_bytes(b"x")
    (tmp_path / "res" / "catB_20250101_000000").mkdir()  # no checkpoint
    for fn, arg in ((lambda m: m.discover_categories, tmp_path / "data"),
                    (lambda m: m.discover_trained_categories, tmp_path / "res")):
        assert fn(campaign)(arg) == fn(jax_campaign)(arg)
    for value in ("all", "a, b,c", "bottle", None):
        assert (campaign.categories_from_arg(value, tmp_path / "data")
                == jax_campaign.categories_from_arg(value, tmp_path / "data"))
    for cat in ("bottle", "bottle_cap", "catA", "catB"):
        assert (campaign.checkpoint_for_category(tmp_path / "res", cat)
                == jax_campaign.checkpoint_for_category(tmp_path / "res", cat))
    with pytest.raises(FileNotFoundError, match="no category"):
        campaign.categories_from_arg("all", tmp_path / "empty")


def test_write_summary_equals_jax(tmp_path):
    rows = {"b": {"auroc": 0.91, "ap": 0.8, "pixel_auroc": 0.95},
            "a": {"auroc": 0.7, "aupro": 0.61234}}
    campaign.write_summary(tmp_path / "port", rows, ["c"], ["d"])
    jax_campaign.write_summary(tmp_path / "jax", rows, ["c"], ["d"])
    for name in ("summary.txt", "summary.csv"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_campaign_trains_and_evaluates_every_category(tmp_path):
    data = tmp_path / "data"
    for cat in ("alpha", "beta"):
        synthetic.create_synthetic_image_data(str(data), cat, n_train=4, n_test_good=2,
                                              n_test_defect=2, image_size=SIZE)
    results = tmp_path / "results"
    runs = train_cli.main(["--device", "cpu", "--category", "all", "--data-dir", str(data),
                           "--image-size", str(SIZE), "--latent-dim", str(LATENT),
                           "--batch-size", "4", "--epochs", "1", "--num-workers", "0",
                           "--results-dir", str(results)])
    assert sorted(runs) == ["alpha", "beta"]
    rows = eval_cli.main(["--checkpoint", str(results), "--category", "all", "--device", "cpu"])
    assert sorted(rows) == ["alpha", "beta"] and all("auroc" in r for r in rows.values())
    summary = (results / "evaluation_all" / "summary.csv").read_text().splitlines()
    assert summary[0] == "category,auroc,ap,pixel_auroc,aupro" and summary[-1].startswith("mean,")


# ------------------------------------------------- parsers and refusals


@pytest.mark.parametrize("ours,theirs", [(train_cli, jax_train_cli),
                                         (eval_cli, jax_eval_cli)], ids=["train", "evaluate"])
def test_parsers_have_the_jax_flags_and_device(ours, theirs):
    got = {a.dest: a.default for a in ours.build_parser()._actions}
    want = {a.dest: a.default for a in theirs.build_parser()._actions}
    assert got.pop("device") == "cuda"
    assert got == want


def test_refusals(data_root, tmp_path):
    from vad_tpu_torch.train.video_trainer import refuse_unported

    base = train_argv(data_root, tmp_path, "--epochs", "1")
    with pytest.raises(NotImplementedError, match="item 10"):
        train_cli.main(base + ["--model-parallel", "2"])
    # the profiling flags (Queue 1 item 11) are ported: accepted
    for flags in (["--tensorboard"], ["--profile-dir", "p"], ["--debug-nans"]):
        refuse_unported(train_cli.build_parser().parse_args(base + flags))
    with pytest.raises(SystemExit):
        train_cli.main(["--category", "all", "--resume", "x.ckpt"])
    with pytest.raises(NotImplementedError, match="item 10"):
        eval_cli.main(["--checkpoint", "x.ckpt", "--device", "cpu", "--data-parallel"])
    if not torch.cuda.is_available():  # the default device is the card, never the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(base[2:])
