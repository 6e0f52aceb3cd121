"""MVTec-format image dataset (the JAX package's
``vad_tpu/data/image_dataset.py``).

Each subfolder of ``<root>/<category>/<split>/`` is a defect type; label 0
iff the folder is named 'good'; a test anomaly pairs with
``ground_truth/<defect>/<name>_mask.png`` when that file exists.  Any
custom category folder with that structure works.  Samples are NHWC
numpy; with ``normalize=False`` the image stays uint8 and the trainer and
evaluator normalize it on the device.  PIL is imported at the first
decode.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from vad_tpu_torch.data.loader import Loader
from vad_tpu_torch.data.video_dataset import IMAGE_EXTS
from vad_tpu_torch.data.video_dataset import _load_u8 as load_image_u8  # decode + resize, u8

MVTEC_CATEGORIES = (
    "bottle", "cable", "capsule", "carpet", "grid",
    "hazelnut", "leather", "metal_nut", "pill", "screw",
    "tile", "toothbrush", "transistor", "wood", "zipper",
)


def load_image(path: str, image_size: int) -> np.ndarray:
    """Decode + resize + normalize to float32 [-1, 1], HWC RGB."""
    return load_image_u8(path, image_size).astype(np.float32) / 127.5 - 1.0


def load_mask(path: str, image_size: int) -> np.ndarray:
    """Ground-truth mask as float32 [H, W] in [0, 1]."""
    from PIL import Image

    img = Image.open(path).convert("L")
    if img.size != (image_size, image_size):
        img = img.resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img, dtype=np.float32) / 255.0


@dataclass(frozen=True)
class ImageRecord:
    path: str
    label: int  # 0 normal, 1 anomaly
    defect_type: str
    mask_path: Optional[str]


class MVTecDataset:
    """Indexable MVTec-format image dataset.

    ``__getitem__`` returns {image [H,W,3] (f32 in [-1, 1], or uint8 with
    ``normalize=False``), label, mask [H,W] f32, path, defect_type}.  With
    ``cache_images`` every image decodes once at construction, bounded by
    ``VAD_FRAME_CACHE_BYTES`` (4 GiB by default)."""

    def __init__(self, root_dir: str, category: str, split: str = "train",
                 image_size: int = 256, normalize: bool = True,
                 cache_images: bool = True) -> None:
        self.root_dir = Path(root_dir)
        self.category = category
        self.split = split
        self.image_size = image_size
        self.normalize = normalize
        self._cache: Optional[np.ndarray] = None

        category_path = self.root_dir / category
        if not category_path.exists():
            raise ValueError(
                f"Category folder not found: {category_path}\n"
                f"Expected structure:\n"
                f"  {category_path}/train/good/\n"
                f"  {category_path}/test/good/\n"
                f"  {category_path}/test/<defect_type>/"
            )
        split_dir = category_path / split
        if not split_dir.exists():
            raise FileNotFoundError(f"Dataset not found at {split_dir}")
        gt_dir = category_path / "ground_truth"

        records: List[ImageRecord] = []
        for defect_type in sorted(os.listdir(split_dir)):
            defect_dir = split_dir / defect_type
            if not defect_dir.is_dir():
                continue
            for name in sorted(os.listdir(defect_dir)):
                if not name.lower().endswith(IMAGE_EXTS):
                    continue
                mask_path = None
                if defect_type != "good":
                    candidate = gt_dir / defect_type / name.replace(".png", "_mask.png")
                    mask_path = str(candidate) if candidate.exists() else None
                records.append(ImageRecord(str(defect_dir / name),
                                           0 if defect_type == "good" else 1,
                                           defect_type, mask_path))
        self.records = records
        if not records:
            raise FileNotFoundError(f"No images found under {split_dir}")

        limit = int(os.environ.get("VAD_FRAME_CACHE_BYTES", 4 * 1024**3))
        if cache_images and len(records) * image_size * image_size * 3 <= limit:
            with ThreadPoolExecutor(max_workers=4) as pool:
                self._cache = np.stack(list(
                    pool.map(lambda r: load_image_u8(r.path, image_size), records)))

    def __len__(self) -> int:
        return len(self.records)

    @property
    def labels(self) -> np.ndarray:
        return np.array([r.label for r in self.records], dtype=np.int64)

    @property
    def defect_types(self) -> List[str]:
        return [r.defect_type for r in self.records]

    def __getitem__(self, idx: int) -> Dict:
        rec = self.records[idx]
        image = (self._cache[idx] if self._cache is not None
                 else load_image_u8(rec.path, self.image_size))
        if self.normalize:
            image = image.astype(np.float32) / 127.5 - 1.0
        if rec.mask_path is not None:
            mask = load_mask(rec.mask_path, self.image_size)
        else:
            mask = np.zeros((self.image_size, self.image_size), dtype=np.float32)
        return {"image": image, "label": np.int64(rec.label), "mask": mask,
                "path": rec.path, "defect_type": rec.defect_type}


def get_dataloaders(root_dir: str, category: str, batch_size: int = 32,
                    image_size: int = 256, num_workers: int = 4):
    """(train, test) ``Loader``s over the normalized float32 splits: host
    numpy batches, the train split shuffled with seed 0, the test split in
    order, the partial tail kept.  Wrap them in ``device_prefetch`` to feed
    a card."""
    train = MVTecDataset(root_dir, category, "train", image_size)
    test = MVTecDataset(root_dir, category, "test", image_size)
    return (Loader(train, batch_size, shuffle=True, num_workers=num_workers, seed=0),
            Loader(test, batch_size, shuffle=False, num_workers=num_workers))
