"""Synthetic MVTec-format image fixtures (the image generators of the JAX
package's ``vad_tpu/data/synthetic.py``, same seeds, so the PNGs are
byte-equal to the JAX package's).

- ``create_synthetic_image_data``: a circle on a gradient background is
  normal; a scratch or a dark spot, with its ground-truth mask, is a
  defect.
- ``create_synthetic_textured_data``: a brushed-surface texture; a
  smudge, a shallow scratch or a faint stain is a defect.

numpy draws everything; PIL writes the PNGs and OpenCV (the textured
fixture only) upsamples its noise and blurs its smudges.  Both are
imported where they are used.

Usage:
    python -m vad_tpu_torch.data.synthetic --data-dir ./data --category synthetic
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Optional, Sequence

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


def _textured_surface(seed: int, size: int) -> np.ndarray:
    """Brushed-surface texture: directional stripes + value noise, uint8
    RGB.  The stripes are the category's; the noise varies with the seed."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
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


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Write a synthetic MVTec-format fixture")
    parser.add_argument("--method", type=str, default="synthetic",
                        choices=["synthetic", "synthetic-textured"])
    parser.add_argument("--data-dir", type=str, default="./data")
    parser.add_argument("--category", type=str, default="synthetic")
    parser.add_argument("--image-size", type=int, default=256)
    args = parser.parse_args(argv)
    if args.method == "synthetic":
        path = create_synthetic_image_data(args.data_dir, args.category,
                                           image_size=args.image_size)
    else:
        category = "textured" if args.category == "synthetic" else args.category
        path = create_synthetic_textured_data(args.data_dir, category,
                                              image_size=args.image_size)
    print(f"Synthetic dataset created at: {path.absolute()}")


if __name__ == "__main__":
    main()
