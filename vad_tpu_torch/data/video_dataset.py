"""Video datasets in the IPAD layout (the JAX package's
``vad_tpu/data/video_dataset.py``, frame-folder part).

A dataset is a list of sliding windows (source, start, label); frames
decode at access time, or, with ``cache_frames`` (default on, bounded by
``VAD_FRAME_CACHE_BYTES``, 4 GiB by default), every source frame decodes
once into a shared uint8 array at construction and windows become memory
slices.  Semantics as in the JAX package:

- IPAD layout ``<cat>/training|testing/frames/<vid>/`` with per-frame
  labels in ``<cat>/test_label/<vid>.npy``; a window is anomalous iff ANY
  frame in it is.
- ``normalize=False`` returns raw uint8 frames (the trainer normalizes on
  the device).

PIL is imported when a frame is decoded, not at import.  The generic
``<cat>/<split>/<label>/`` layout of video files needs OpenCV and is not
ported yet (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

IMAGE_EXTS = (".png", ".jpg", ".jpeg")


def _load_u8(path: str, image_size: int) -> np.ndarray:
    """Decode + resize an image file to uint8 RGB [H, W, 3]."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (image_size, image_size):
        img = img.resize((image_size, image_size), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


@dataclass
class Window:
    """One sliding-window sample (metadata only; frames decode lazily)."""

    source: Tuple[str, ...]  # frame paths of one video
    start: int
    label: int
    label_name: str
    video_id: str
    frame_labels: Optional[np.ndarray] = None  # per-frame 0/1, test only


class _WindowDataset:
    """Shared base: window list + lazy (or cached) decode + dict samples."""

    def __init__(self, sequence_length: int, stride: int, image_size: int,
                 cache_frames: bool = True, normalize: bool = True) -> None:
        self.sequence_length = sequence_length
        self.stride = stride
        self.image_size = image_size
        self.cache_frames = cache_frames
        self.normalize = normalize
        self.windows: List[Window] = []
        self._cache: Dict[Tuple[str, ...], np.ndarray] = {}

    def _cache_limit_bytes(self) -> int:
        return int(os.environ.get("VAD_FRAME_CACHE_BYTES", 4 * 1024**3))

    def _build_frame_cache(self) -> None:
        """Decode every distinct source once into uint8 [N, H, W, 3]."""
        if not self.cache_frames or not self.windows:
            return
        sources = list(dict.fromkeys(w.source for w in self.windows))
        total_frames = sum(len(s) for s in sources)
        if total_frames * self.image_size * self.image_size * 3 > self._cache_limit_bytes():
            self.cache_frames = False
            return
        workers = max(1, min(len(sources), os.cpu_count() or 1, 8))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            for src in sources:
                self._cache[src] = np.stack(
                    list(pool.map(lambda p: _load_u8(p, self.image_size), src)))

    def __len__(self) -> int:
        return len(self.windows)

    @property
    def labels(self) -> np.ndarray:
        return np.array([w.label for w in self.windows], dtype=np.int64)

    def _decode_u8(self, w: Window) -> np.ndarray:
        """uint8 [T, H, W, 3] window frames (cache hit = memory slice)."""
        cached = self._cache.get(w.source)
        if cached is not None:
            return cached[w.start : w.start + self.sequence_length]
        paths = w.source[w.start : w.start + self.sequence_length]
        return np.stack([_load_u8(p, self.image_size) for p in paths])

    def __getitem__(self, idx: int) -> Dict:
        w = self.windows[idx]
        u8 = self._decode_u8(w)
        sample = {
            "frames": u8 if not self.normalize else u8.astype(np.float32) / 127.5 - 1.0,
            "label": np.int64(w.label),
            "start_frame": np.int64(w.start),
            "video": w.video_id,
        }
        if w.frame_labels is not None:
            sample["frame_labels"] = w.frame_labels.astype(np.int64)
        else:  # uniform keys across samples so batches stack cleanly
            sample["frame_labels"] = np.full(self.sequence_length, w.label, dtype=np.int64)
        return sample

    def _add_windows(self, source: Tuple[str, ...], label: int, label_name: str,
                     video_id: str, frame_labels: Optional[np.ndarray]) -> None:
        total = len(source)
        for start in range(0, total - self.sequence_length + 1, self.stride):
            end = start + self.sequence_length
            fl = None
            win_label = label
            if frame_labels is not None:
                fl = np.asarray(frame_labels[start:end])
                win_label = int(np.any(fl == 1))  # anomalous iff ANY frame is
            self.windows.append(Window(source, start, win_label, label_name, video_id, fl))


class IPADDataset(_WindowDataset):
    """IPAD-format dataset: ``<root>/<category>/training|testing/frames``."""

    def __init__(
        self,
        root_dir: str,
        category: str,
        split: str = "train",
        sequence_length: int = 16,
        stride: int = 4,
        image_size: int = 256,
        cache_frames: bool = True,
        normalize: bool = True,
    ) -> None:
        super().__init__(sequence_length, stride, image_size, cache_frames, normalize)
        root = Path(root_dir) / category
        if split == "train":
            frames_dir, labels_dir = root / "training" / "frames", None
        else:
            frames_dir, labels_dir = root / "testing" / "frames", root / "test_label"
        if not frames_dir.exists():
            raise FileNotFoundError(f"Dataset not found at {frames_dir}")
        for video_folder in sorted(frames_dir.iterdir()):
            if not video_folder.is_dir():
                continue
            vid = video_folder.name
            paths = tuple(str(f) for f in sorted(video_folder.iterdir())
                          if f.suffix.lower() in IMAGE_EXTS)
            frame_labels = None
            if labels_dir is not None:
                # both zero-padded-numeric and literal naming conventions
                candidates = [labels_dir / f"{vid}.npy"]
                try:
                    candidates.insert(0, labels_dir / f"{int(vid):03d}.npy")
                except ValueError:
                    pass
                for c in candidates:
                    if c.exists():
                        frame_labels = np.load(c)
                        break
            self._add_windows(paths, 0, "normal", vid, frame_labels)
        self._build_frame_cache()


def detect_video_dataset_class(root_dir: str, category: str):
    """``IPADDataset`` iff ``<cat>/training/frames`` exists.  The generic
    layout (``VideoDataset`` over video files, OpenCV) is not ported yet:
    it raises."""
    if (Path(root_dir) / category / "training" / "frames").exists():
        return IPADDataset
    raise NotImplementedError(
        f"{Path(root_dir) / category} is not in the IPAD layout "
        "(<category>/training/frames); the generic video-file layout is not "
        "ported yet (ROADMAP Queue 1 item 4)"
    )
