"""Synthetic fixtures and dataset set-up (the JAX package's
``vad_tpu/data/synthetic.py``: same seeds, arithmetic and call order, so
the PNGs, label files and mp4 frames are equal to the JAX package's).

- ``create_synthetic_image_data``: a circle on a gradient background is
  normal; a scratch or a dark spot, with its ground-truth mask, is a
  defect (MVTec layout).
- ``create_synthetic_textured_data``: a brushed-surface texture; a
  smudge, a shallow scratch or a faint stain is a defect.
- ``create_synthetic_video_data``: a circle orbits the centre; in the
  even-indexed test videos a dark intruder appears over the middle of the
  clip (IPAD layout, per-frame labels under ``test_label/``).
- ``create_synthetic_textured_video_data``: a scrolling periodic texture;
  the anomaly is a patch scrolling against the global motion.
- ``create_synthetic_video_file``: one orbit clip as an mp4 (mp4v).
- ``install_mvtec_categories`` / ``download_with_kagglehub``: copy an
  extracted MVTec AD download into the data dir, or fetch it with
  kagglehub (without the package, credentials or a network it prints
  how to install by hand and returns None).

numpy draws everything; PIL writes the PNGs and OpenCV upsamples the
textures' noise, blurs smudges and writes mp4s.  Both are imported where
they are used.

Usage:
    python -m vad_tpu_torch.data.synthetic --method synthetic-video \
        --data-dir ./data --category S01
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from vad_tpu_torch.data.video_dataset import cv2_module


def _gradient_bg(size: int) -> np.ndarray:
    """Vertical gradient background, RGB uint8 [size, size, 3]."""
    rows = np.arange(size, dtype=np.int32)
    base = np.stack([50 + rows // 4, 50 + rows // 4, 60 + rows // 4], axis=-1)
    return np.broadcast_to(base[:, None, :], (size, size, 3)).astype(np.uint8)


def _disk_mask(size: int, cx: float, cy: float, radius: float) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size]
    return (xx - cx) ** 2 + (yy - cy) ** 2 <= radius**2


def _ring_mask(size: int, cx: float, cy: float, radius: float, width: float) -> np.ndarray:
    yy, xx = np.mgrid[0:size, 0:size]
    d2 = (xx - cx) ** 2 + (yy - cy) ** 2
    return (d2 <= (radius + width / 2) ** 2) & (d2 >= (radius - width / 2) ** 2)


def _normal_image(seed: int, size: int) -> np.ndarray:
    """Clean circle on a gradient background (deterministic per seed)."""
    rng = np.random.default_rng(seed)
    img = _gradient_bg(size).copy()
    center = size // 2
    radius = (60 + int(rng.integers(-10, 10))) * size // 256
    img[_disk_mask(size, center, center, radius)] = (200, 200, 210)
    img[_ring_mask(size, center, center, radius, max(3 * size // 256, 2))] = (150, 150, 160)
    return img


def _line_mask(size: int, p1, p2, width: int) -> np.ndarray:
    """Rasterize a thick line segment as a boolean mask."""
    n = max(abs(p2[0] - p1[0]), abs(p2[1] - p1[1]), 1) * 4
    ts = np.linspace(0.0, 1.0, n)
    xs = np.clip(np.round(p1[0] + ts * (p2[0] - p1[0])).astype(int), 0, size - 1)
    ys = np.clip(np.round(p1[1] + ts * (p2[1] - p1[1])).astype(int), 0, size - 1)
    mask = np.zeros((size, size), dtype=bool)
    r = width // 2
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            mask[np.clip(ys + dy, 0, size - 1), np.clip(xs + dx, 0, size - 1)] = True
    return mask


def _defect_image(seed: int, size: int) -> tuple[np.ndarray, np.ndarray]:
    """Normal image plus a scratch or dark spot; returns (image, gt_mask)."""
    img = _normal_image(seed, size).copy()
    rng = np.random.default_rng(seed + 1000)
    s = size / 256.0
    if rng.random() > 0.5:  # scratch
        x1 = int(rng.integers(int(80 * s), int(180 * s)))
        y1 = int(rng.integers(int(80 * s), int(180 * s)))
        x2 = x1 + int(rng.integers(int(-40 * s), int(40 * s)))
        y2 = y1 + int(rng.integers(int(-40 * s), int(40 * s)))
        draw = _line_mask(size, (x1, y1), (x2, y2), max(int(3 * s), 2))
        gt = _line_mask(size, (x1, y1), (x2, y2), max(int(5 * s), 3))
        img[draw] = (50, 50, 50)
    else:  # spot
        cx = int(rng.integers(int(100 * s), int(156 * s)))
        cy = int(rng.integers(int(100 * s), int(156 * s)))
        r = int(rng.integers(max(int(5 * s), 2), max(int(15 * s), 4)))
        gt = _disk_mask(size, cx, cy, r)
        img[gt] = (30, 30, 30)
    return img, (gt.astype(np.uint8) * 255)


def _write_fixture(data_dir: str, category: str, n_train: int, n_test_good: int,
                   n_test_defect: int, normal: Callable[[int], np.ndarray],
                   defect: Callable[[int], tuple], seeds: Sequence[int]) -> Path:
    """The MVTec layout: ``train/good``, ``test/{good,defect}`` and
    ``ground_truth/defect/NNN_mask.png``; ``seeds`` offsets the train,
    test-good and test-defect draws."""
    from PIL import Image

    base = Path(data_dir) / category
    paths = {
        "train": base / "train" / "good",
        "good": base / "test" / "good",
        "defect": base / "test" / "defect",
        "gt": base / "ground_truth" / "defect",
    }
    for p in paths.values():
        p.mkdir(parents=True, exist_ok=True)
    for i in range(n_train):
        Image.fromarray(normal(i + seeds[0])).save(paths["train"] / f"{i:03d}.png")
    for i in range(n_test_good):
        Image.fromarray(normal(i + seeds[1])).save(paths["good"] / f"{i:03d}.png")
    for i in range(n_test_defect):
        img, mask = defect(i + seeds[2])
        Image.fromarray(img).save(paths["defect"] / f"{i:03d}.png")
        Image.fromarray(mask).save(paths["gt"] / f"{i:03d}_mask.png")
    return base


def create_synthetic_image_data(data_dir: str = "./data", category: str = "synthetic",
                                n_train: int = 50, n_test_good: int = 10,
                                n_test_defect: int = 20, image_size: int = 256) -> Path:
    """Write the circle fixture in the MVTec layout (seeds: train i,
    test-good i+100, test-defect i+200); returns ``<data_dir>/<category>``."""
    return _write_fixture(data_dir, category, n_train, n_test_good, n_test_defect,
                          lambda s: _normal_image(s, image_size),
                          lambda s: _defect_image(s, image_size), (0, 100, 200))


def _value_noise(rng: np.random.Generator, size: int, octaves=(4, 8, 16, 32)) -> np.ndarray:
    """Multi-octave value noise in [0, 1] (bicubic upsampling)."""
    cv2 = cv2_module()
    img = np.zeros((size, size), np.float32)
    amp_total = 0.0
    for i, o in enumerate(octaves):
        amp = 1.0 / (i + 1)
        grid = rng.random((o, o)).astype(np.float32)
        img += amp * cv2.resize(grid, (size, size), interpolation=cv2.INTER_CUBIC)
        amp_total += amp
    img /= amp_total
    return np.clip(img, 0.0, 1.0)


def _periodic_value_noise(rng: np.random.Generator, size: int,
                          octaves=(4, 8, 16, 32)) -> np.ndarray:
    """``size``-periodic multi-octave value noise: each octave's coarse grid
    is tiled 2x2 before upsampling and the central period cropped, so the
    interpolation sees wrapped neighbours at the seam."""
    cv2 = cv2_module()
    img = np.zeros((size, size), np.float32)
    amp_total = 0.0
    for i, o in enumerate(octaves):
        amp = 1.0 / (i + 1)
        grid = np.tile(rng.random((o, o)).astype(np.float32), (2, 2))
        big = cv2.resize(grid, (2 * size, 2 * size), interpolation=cv2.INTER_CUBIC)
        img += amp * big[size // 2 : size // 2 + size, size // 2 : size // 2 + size]
        amp_total += amp
    return np.clip(img / amp_total, 0.0, 1.0)


def _textured_surface(seed: int, size: int, periodic: bool = False) -> np.ndarray:
    """Brushed-surface texture: directional stripes + value noise, uint8
    RGB.  The stripes are the category's; the noise varies with the seed.
    With ``periodic`` the texture tiles with period ``size`` (integer
    stripe cycles, wrap-padded noise), for the scrolling video fixture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    if periodic:
        two_pi = 2.0 * np.pi
        kx = max(1, round(0.35 * size / two_pi))  # integer cycles per period
        ky = max(1, round(0.01 * size / two_pi))
        stripes = 0.5 + 0.08 * np.sin(
            xx * (kx * two_pi / size) + 3.0 * np.sin(yy * (ky * two_pi / size))
        )
        noise = _periodic_value_noise(rng, size)
    else:
        stripes = 0.5 + 0.08 * np.sin(xx * 0.35 + 3.0 * np.sin(yy * 0.01))
        noise = _value_noise(rng, size)
    lum = np.clip(0.65 * stripes + 0.35 * noise, 0, 1)
    base = (lum * 155 + 60).astype(np.uint8)
    return np.stack([base, base, (base * 0.96).astype(np.uint8)], axis=-1)


def _textured_defect(seed: int, size: int) -> tuple[np.ndarray, np.ndarray]:
    """Subtle low-contrast defect on the textured surface + GT mask."""
    img = _textured_surface(seed, size).astype(np.int16)
    rng = np.random.default_rng(seed + 5000)
    kind = rng.integers(0, 3)
    mask = np.zeros((size, size), bool)
    if kind == 0:  # smudge: local blur destroys the stripe texture
        cx, cy = rng.integers(size // 4, 3 * size // 4, size=2)
        r = int(rng.integers(size // 16, size // 8))
        mask = _disk_mask(size, cx, cy, r)
        blurred = cv2_module().GaussianBlur(img.astype(np.uint8), (0, 0), sigmaX=size / 40)
        img[mask] = blurred[mask]
    elif kind == 1:  # shallow scratch across the grain
        x1, y1 = rng.integers(size // 5, 4 * size // 5, size=2)
        x2 = int(np.clip(x1 + rng.integers(-size // 3, size // 3), 0, size - 1))
        y2 = int(np.clip(y1 + rng.integers(-size // 3, size // 3), 0, size - 1))
        mask = _line_mask(size, (x1, y1), (x2, y2), max(size // 86, 2))
        img[mask] -= int(rng.integers(18, 30))
    else:  # faint stain: small local brightness shift
        cx, cy = rng.integers(size // 4, 3 * size // 4, size=2)
        r = int(rng.integers(size // 12, size // 7))
        mask = _disk_mask(size, cx, cy, r)
        img[mask] += int(rng.integers(14, 24)) * (1 if rng.random() > 0.5 else -1)
    return np.clip(img, 0, 255).astype(np.uint8), mask.astype(np.uint8) * 255


def create_synthetic_textured_data(data_dir: str = "./data", category: str = "textured",
                                   n_train: int = 60, n_test_good: int = 15,
                                   n_test_defect: int = 25, image_size: int = 256) -> Path:
    """The harder fixture: structured texture, low-contrast defects, same
    layout (seeds: train i, test-good i+300, test-defect i+600)."""
    return _write_fixture(data_dir, category, n_train, n_test_good, n_test_defect,
                          lambda s: _textured_surface(s, image_size),
                          lambda s: _textured_defect(s, image_size), (0, 300, 600))


def _video_frame(t: int, size: int, phase: float, speed: float, anomaly: bool,
                 rng: np.random.Generator) -> np.ndarray:
    """One frame: a circle orbiting the centre; with ``anomaly``, a dark
    intruder moving against the orbit."""
    img = _gradient_bg(size).copy()
    center = size / 2
    orbit_r = size * 0.27
    ang = phase + speed * t
    cx = center + orbit_r * np.cos(ang)
    cy = center + orbit_r * np.sin(ang)
    r = size * 0.11
    img[_disk_mask(size, cx, cy, r)] = (200, 200, 210)
    img[_ring_mask(size, cx, cy, r, max(size // 96, 2))] = (150, 150, 160)
    if anomaly:
        ix = size - cx
        iy = size - cy
        ir = size * 0.09 + rng.normal() * size * 0.01
        img[_disk_mask(size, ix, iy, max(ir, 2))] = (25, 25, 30)
    return img


def _ipad_dirs(data_dir: str, category: str) -> tuple:
    """``<category>/training/frames``, ``testing/frames`` and
    ``test_label``, created; returns (base, train, test, labels)."""
    base = Path(data_dir) / category
    dirs = (base / "training" / "frames", base / "testing" / "frames", base / "test_label")
    for p in dirs:
        p.mkdir(parents=True, exist_ok=True)
    return (base, *dirs)


def create_synthetic_video_data(data_dir: str = "./data", category: str = "synthetic_video",
                                n_train_videos: int = 4, n_test_videos: int = 4,
                                frames_per_video: int = 48, image_size: int = 256) -> Path:
    """Write the orbit fixture in the IPAD layout:
    ``training/frames/<vid>/NNNN.png``, ``testing/frames/<vid>/NNNN.png``
    and ``test_label/<vid>.npy`` (per-frame 0/1).  Training videos are all
    normal (seeds 10,000 + v); even-indexed test videos (seeds 20,000 + v)
    hold the intruder over frames [0.4, 0.7) of the clip, odd-indexed ones
    stay normal."""
    from PIL import Image

    base, train_frames, test_frames, label_dir = _ipad_dirs(data_dir, category)
    for v in range(n_train_videos):
        rng = np.random.default_rng(10_000 + v)
        vdir = train_frames / f"{v:02d}"
        vdir.mkdir(exist_ok=True)
        phase = rng.uniform(0, 2 * np.pi)
        speed = rng.uniform(0.12, 0.2)
        for t in range(frames_per_video):
            frame = _video_frame(t, image_size, phase, speed, False, rng)
            Image.fromarray(frame).save(vdir / f"{t:04d}.png")

    for v in range(n_test_videos):
        rng = np.random.default_rng(20_000 + v)
        vdir = test_frames / f"{v:02d}"
        vdir.mkdir(exist_ok=True)
        phase = rng.uniform(0, 2 * np.pi)
        speed = rng.uniform(0.12, 0.2)
        labels = np.zeros(frames_per_video, dtype=np.int64)
        if v % 2 == 0:
            labels[int(frames_per_video * 0.4):int(frames_per_video * 0.7)] = 1
        for t in range(frames_per_video):
            frame = _video_frame(t, image_size, phase, speed, bool(labels[t]), rng)
            Image.fromarray(frame).save(vdir / f"{t:04d}.png")
        np.save(label_dir / f"{v:02d}.npy", labels)
    return base


def create_synthetic_textured_video_data(data_dir: str = "./data",
                                         category: str = "textured_video",
                                         n_train_videos: int = 4, n_test_videos: int = 4,
                                         frames_per_video: int = 96,
                                         image_size: int = 256) -> Path:
    """The IPAD-layout fixture with a purely temporal anomaly: every frame
    is a window onto one category-wide periodic texture (seed 424,242,
    tiled 2x2) scrolling at a per-video velocity (seeds 40,000 + v train,
    50,000 + v test); over frames [0.4, 0.75) of the even-indexed test
    videos a disk of it scrolls the opposite way.  Each frame alone is a
    plausible texture, so only temporal modelling separates them."""
    from PIL import Image

    base, train_frames, test_frames, label_dir = _ipad_dirs(data_dir, category)
    canvas = np.tile(_textured_surface(424242, image_size, periodic=True), (2, 2, 1))

    def write_video(vdir: Path, seed: int, labels: Optional[np.ndarray]) -> None:
        vdir.mkdir(exist_ok=True)
        rng = np.random.default_rng(seed)
        vx, vy = rng.integers(1, 4, size=2) * (1 if rng.random() > 0.5 else -1)
        patch_mask = None
        if labels is not None and labels.any():
            cx, cy = rng.integers(image_size // 4, 3 * image_size // 4, size=2)
            r = int(rng.integers(image_size // 8, image_size // 5))
            patch_mask = _disk_mask(image_size, cx, cy, r)
        for t in range(frames_per_video):
            ox = (vx * t) % image_size
            oy = (vy * t) % image_size
            frame = canvas[oy : oy + image_size, ox : ox + image_size].copy()
            if labels is not None and labels[t]:
                ox2 = (-vx * t) % image_size
                oy2 = (-vy * t) % image_size
                counter = canvas[oy2 : oy2 + image_size, ox2 : ox2 + image_size]
                frame[patch_mask] = counter[patch_mask]
            Image.fromarray(frame).save(vdir / f"{t:04d}.png")

    for v in range(n_train_videos):
        write_video(train_frames / f"{v:02d}", 40_000 + v, None)
    for v in range(n_test_videos):
        labels = np.zeros(frames_per_video, dtype=np.int64)
        if v % 2 == 0:
            labels[int(frames_per_video * 0.4):int(frames_per_video * 0.75)] = 1
        write_video(test_frames / f"{v:02d}", 50_000 + v, labels)
        np.save(label_dir / f"{v:02d}.npy", labels)
    return base


def create_synthetic_video_file(path: str, n_frames: int = 120, image_size: int = 256,
                                fps: float = 30.0,
                                anomaly_range: Optional[Tuple[int, int]] = None,
                                seed: int = 0) -> str:
    """One orbit clip (speed 0.15, phase from ``seed``) written as an mp4
    (OpenCV's mp4v), the intruder over frames [a, b) of ``anomaly_range``;
    returns the path."""
    cv2 = cv2_module()
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0, 2 * np.pi)
    speed = 0.15
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (image_size, image_size))
    try:
        for t in range(n_frames):
            anom = anomaly_range is not None and anomaly_range[0] <= t < anomaly_range[1]
            frame = _video_frame(t, image_size, phase, speed, anom, rng)
            writer.write(frame[:, :, ::-1])  # RGB -> BGR
    finally:
        writer.release()
    return str(path)


def install_mvtec_categories(src_dir: str, data_dir: str) -> Path:
    """Copy every category folder of an extracted MVTec AD download that
    ``data_dir`` lacks into it; returns ``data_dir``."""
    import shutil

    src, dst = Path(src_dir), Path(data_dir)
    dst.mkdir(parents=True, exist_ok=True)
    for cat in sorted(p.name for p in src.iterdir() if p.is_dir()):
        if not (dst / cat).exists():
            print(f"Copying {cat}...")
            shutil.copytree(src / cat, dst / cat)
    print(f"Dataset ready at: {dst.absolute()}")
    return dst


def download_with_kagglehub(data_dir: str = "./data") -> Optional[str]:
    """Download MVTec AD with kagglehub and install its categories under
    ``data_dir``; returns kagglehub's path, or None (after printing how to
    install by hand) when kagglehub is missing or the download fails
    (no credentials, no network)."""
    fallback = (
        "Falling back to manual install: download "
        "https://www.kaggle.com/datasets/ipythonx/mvtec-ad , extract it, "
        "and run with --method manual --kaggle-path /path/to/extracted/mvtec."
    )
    try:
        import kagglehub
    except ImportError:
        print("kagglehub is not installed (pip install kagglehub).")
        print(fallback)
        return None
    print("Downloading MVTec AD from Kaggle (ipythonx/mvtec-ad)...")
    print("Note: requires Kaggle API credentials (~/.kaggle/kaggle.json)")
    try:
        path = kagglehub.dataset_download("ipythonx/mvtec-ad")
    except Exception as e:  # noqa: BLE001 - network and credential failures
        print(f"Download failed: {e}")
        print(fallback)
        return None
    print(f"Downloaded to: {path}")
    install_mvtec_categories(path, data_dir)
    return path


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Set up anomaly-detection datasets")
    parser.add_argument("--method", type=str, default="synthetic",
                        choices=["synthetic", "synthetic-textured", "synthetic-video",
                                 "synthetic-textured-video", "kagglehub", "manual"])
    parser.add_argument("--kaggle-path", type=str, default=None)
    parser.add_argument("--data-dir", type=str, default="./data")
    parser.add_argument("--category", type=str, default="synthetic")
    parser.add_argument("--image-size", type=int, default=256)
    args = parser.parse_args(argv)
    size = dict(image_size=args.image_size)
    if args.method == "synthetic":
        path = create_synthetic_image_data(args.data_dir, args.category, **size)
        print(f"Synthetic image dataset created at: {path.absolute()}")
    elif args.method == "synthetic-textured":
        category = "textured" if args.category == "synthetic" else args.category
        path = create_synthetic_textured_data(args.data_dir, category, **size)
        print(f"Synthetic textured dataset created at: {path.absolute()}")
    elif args.method == "synthetic-video":
        path = create_synthetic_video_data(args.data_dir, args.category, **size)
        print(f"Synthetic video dataset created at: {path.absolute()}")
    elif args.method == "synthetic-textured-video":
        category = "textured_video" if args.category == "synthetic" else args.category
        path = create_synthetic_textured_video_data(args.data_dir, category, **size)
        print(f"Synthetic textured video dataset created at: {path.absolute()}")
    elif args.method == "kagglehub":
        download_with_kagglehub(args.data_dir)
    elif not args.kaggle_path:  # manual
        print("Pass --kaggle-path /path/to/extracted/mvtec to install it.")
    else:
        install_mvtec_categories(args.kaggle_path, args.data_dir)


if __name__ == "__main__":
    main()
