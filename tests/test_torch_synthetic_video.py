"""The port's video generators and dataset CLI against the JAX package's.

Every PNG and label ``.npy`` the port's generators write is byte-equal to
the JAX package's at small sizes (the periodic texture included); an mp4
written by each package decodes, through the same OpenCV in this process,
to equal frames; ``python -m vad_tpu_torch.data.synthetic`` takes all six
methods.  ``kagglehub`` runs with no such module and with stub modules
that raise or return a local directory: nothing touches the network.
"""

import sys
import types

import numpy as np
import pytest

from vad_tpu.data import synthetic as jax_synthetic
from vad_tpu_torch.data import synthetic

VIDEO = dict(n_train_videos=2, n_test_videos=2, frames_per_video=14, image_size=40)


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    return {p.relative_to(root): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def assert_same_files(port_root, jax_root, n_png, n_npy):
    got, want = tree_bytes(port_root), tree_bytes(jax_root)
    assert sorted(got) == sorted(want)
    assert sum(p.suffix == ".png" for p in got) == n_png
    assert sum(p.suffix == ".npy" for p in got) == n_npy
    for path, data in got.items():
        assert data == want[path], path


@pytest.mark.parametrize("make", ["create_synthetic_video_data",
                                  "create_synthetic_textured_video_data"])
def test_video_fixtures_equal_jax(make, tmp_path):
    for pkg, side in ((synthetic, "port"), (jax_synthetic, "jax")):
        getattr(pkg, make)(str(tmp_path / side), "V01", **VIDEO)
    assert_same_files(tmp_path / "port", tmp_path / "jax", 4 * 14, 2)
    labels = np.load(tmp_path / "port" / "V01" / "test_label" / "00.npy")
    assert labels.dtype == np.int64 and 0 < labels.sum() < len(labels)
    assert not np.load(tmp_path / "port" / "V01" / "test_label" / "01.npy").any()


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("size", [37, 64])
def test_textured_surface_equals_jax(periodic, size):
    got = synthetic._textured_surface(7, size, periodic=periodic)
    np.testing.assert_array_equal(got, jax_synthetic._textured_surface(7, size,
                                                                       periodic=periodic))


@pytest.mark.parametrize("t,anomaly", [(0, False), (5, True), (31, True)])
def test_video_frame_equals_jax(t, anomaly):
    frames = [pkg._video_frame(t, 48, 1.3, 0.17, anomaly, np.random.default_rng(3))
              for pkg in (synthetic, jax_synthetic)]
    np.testing.assert_array_equal(*frames)


def decoded(path):
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


@pytest.mark.parametrize("anomaly_range", [None, (4, 9)])
def test_mp4_decodes_to_jax_frames(anomaly_range, tmp_path):
    kw = dict(n_frames=12, image_size=48, fps=25.0, anomaly_range=anomaly_range, seed=4)
    got = synthetic.create_synthetic_video_file(str(tmp_path / "port.mp4"), **kw)
    want = jax_synthetic.create_synthetic_video_file(str(tmp_path / "jax.mp4"), **kw)
    assert got == str(tmp_path / "port.mp4")
    a, b = decoded(got), decoded(want)
    assert a.shape == (12, 48, 48, 3)
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------- CLI

GENERATED = {  # method -> (JAX generator, category it writes to, PNGs, label files)
    "synthetic": ("create_synthetic_image_data", "synthetic", 50 + 10 + 20 + 20, 0),
    "synthetic-textured": ("create_synthetic_textured_data", "textured", 60 + 15 + 25 + 25,
                           0),
    "synthetic-video": ("create_synthetic_video_data", "synthetic", 8 * 48, 4),
    "synthetic-textured-video": ("create_synthetic_textured_video_data", "textured_video",
                                 8 * 96, 4),
}


@pytest.mark.parametrize("method", sorted(GENERATED))
def test_main_generates_what_jax_generates(method, tmp_path, capsys):
    make, category, n_png, n_npy = GENERATED[method]
    synthetic.main(["--method", method, "--data-dir", str(tmp_path / "port"),
                    "--image-size", "24"])
    out = capsys.readouterr().out
    assert f"created at: {(tmp_path / 'port' / category).absolute()}" in out
    getattr(jax_synthetic, make)(str(tmp_path / "jax"), category, image_size=24)
    assert_same_files(tmp_path / "port", tmp_path / "jax", n_png, n_npy)


def mvtec_download(root):
    """A local stand-in for an extracted MVTec AD download."""
    for cat in ("bottle", "cable"):
        (root / cat / "train" / "good").mkdir(parents=True)
        (root / cat / "train" / "good" / "000.png").write_bytes(cat.encode())
    (root / "license.txt").write_text("not a category")
    return root


def kaggle_stub(download):
    mod = types.ModuleType("kagglehub")
    mod.dataset_download = download
    return mod


def fail(name):
    raise ConnectionError("no network")


@pytest.mark.parametrize("stub", ["missing", "raises", "returns"])
def test_kagglehub_as_jax(stub, tmp_path, monkeypatch, capsys):
    src = mvtec_download(tmp_path / "download")
    module = {"missing": None, "raises": kaggle_stub(fail),
              "returns": kaggle_stub(lambda name: str(src))}[stub]
    monkeypatch.setitem(sys.modules, "kagglehub", module)  # None: import fails
    outs, results = [], []
    for pkg, side in ((synthetic, "port"), (jax_synthetic, "jax")):
        results.append(pkg.download_with_kagglehub(str(tmp_path / side)))
        outs.append(capsys.readouterr().out.replace(str(tmp_path / side), "<data>"))
    assert outs[0] == outs[1]
    assert results[0] == results[1] == (str(src) if stub == "returns" else None)
    if stub == "returns":
        assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["bottle", "cable"]
        assert tree_bytes(tmp_path / "port") == tree_bytes(tmp_path / "jax")
    else:
        assert "--method manual --kaggle-path" in outs[0]
        assert not (tmp_path / "port").exists()
    synthetic.main(["--method", "kagglehub", "--data-dir", str(tmp_path / "cli")])
    assert capsys.readouterr().out.replace(str(tmp_path / "cli"), "<data>") == outs[0]


def test_manual_install(tmp_path, capsys):
    src = mvtec_download(tmp_path / "download")
    synthetic.main(["--method", "manual", "--data-dir", str(tmp_path / "d")])
    assert "Pass --kaggle-path" in capsys.readouterr().out and not (tmp_path / "d").exists()
    (tmp_path / "d" / "bottle").mkdir(parents=True)  # present categories stay as they are
    synthetic.main(["--method", "manual", "--kaggle-path", str(src), "--data-dir",
                    str(tmp_path / "d")])
    out = capsys.readouterr().out
    assert "Copying cable..." in out and "Copying bottle" not in out
    assert f"Dataset ready at: {(tmp_path / 'd').absolute()}" in out
    assert (tmp_path / "d" / "cable" / "train" / "good" / "000.png").read_bytes() == b"cable"
    assert not any((tmp_path / "d" / "bottle").iterdir())
