"""Video datasets: the IPAD layout, generic folders and single video files
(the JAX package's ``vad_tpu/data/video_dataset.py``).

A dataset is a list of sliding windows (source, start, label); frames
decode at access time, or, with ``cache_frames`` (default on, bounded by
``VAD_FRAME_CACHE_BYTES``, 4 GiB by default), every source frame decodes
once into a shared uint8 array at construction and windows become memory
slices.  Semantics as in the JAX package:

- IPAD layout ``<cat>/training|testing/frames/<vid>/`` with per-frame
  labels in ``<cat>/test_label/<vid>.npy``; a window is anomalous iff ANY
  frame in it is.
- Generic layout ``<cat>/<split>/<label_folder>/`` holding video files
  (.mp4/.avi/.mov/.mkv) or frame folders; label 0 iff the folder is named
  good/normal/train.
- ``VideoFileDataset``: stride-S windows over one video file, for
  inference, with the raw frames beside the normalized ones.
- ``normalize=False`` returns raw uint8 frames (the trainer and the
  evaluator normalize on the device).

Each dataset keeps per-thread ``cv2.VideoCapture`` handles and skips the
seek when a window starts where the last read ended, so dense stride-1
reads decode each frame once.  PIL and OpenCV are imported where a frame
is decoded, not at import: the machine with the card may have neither.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

IMAGE_EXTS = (".png", ".jpg", ".jpeg")
VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv")

Source = Union[str, Tuple[str, ...]]  # a video file, or the frame paths of one video


def cv2_module():
    """OpenCV, imported at first use; RuntimeError naming the need when it
    is not installed."""
    try:
        import cv2
    except ImportError as exc:
        raise RuntimeError(f"OpenCV (cv2) is required to decode video files ({exc})") from exc
    return cv2


def resize_u8(frame_rgb: np.ndarray, image_size: int) -> np.ndarray:
    """Bilinear resize to ``image_size``², a no-op (and no cv2) at that size."""
    if frame_rgb.shape[:2] == (image_size, image_size):
        return frame_rgb
    cv2 = cv2_module()
    return cv2.resize(frame_rgb, (image_size, image_size), interpolation=cv2.INTER_LINEAR)


def _normalize_frame(frame_rgb: np.ndarray, image_size: int) -> np.ndarray:
    """uint8 RGB frame -> resized float32 [-1, 1] HWC."""
    return resize_u8(frame_rgb, image_size).astype(np.float32) / 127.5 - 1.0


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

    source: Source
    start: int
    label: int
    label_name: str
    video_id: str
    frame_labels: Optional[np.ndarray] = None  # per-frame 0/1, test only


class _CaptureCache:
    """Per-thread ``cv2.VideoCapture`` pool with sequential-read detection.

    At most ``max_per_thread`` handles per thread (the oldest is released
    first); ``close`` releases every thread's handles, and ``__del__`` does
    so at garbage collection."""

    def __init__(self, max_per_thread: int = 8) -> None:
        self._local = threading.local()
        self.max_per_thread = max_per_thread
        # thread-local stores are invisible to close(): track them here
        self._stores: List[Dict] = []
        self._stores_lock = threading.Lock()

    def close(self) -> None:
        """Release every cached handle of every thread (the stores stay
        registered, so reads after close are tracked again)."""
        with self._stores_lock:
            stores = list(self._stores)
        for store in stores:
            for cap, _ in list(store.values()):
                cap.release()
            store.clear()

    def __del__(self) -> None:  # pragma: no cover - GC timing dependent
        try:
            self.close()
        except Exception:
            pass

    def open_handles(self) -> int:
        with self._stores_lock:
            return sum(len(s) for s in self._stores)

    def read_window(self, path: str, start: int, length: int) -> List[np.ndarray]:
        """``length`` RGB frames of ``path`` from frame ``start``.  A short
        read (a corrupt tail) is padded with its last frame; a window that
        decodes no frame at all raises."""
        cv2 = cv2_module()
        store = getattr(self._local, "caps", None)
        if store is None:
            store = self._local.caps = {}
            with self._stores_lock:
                self._stores.append(store)
        cap, pos = store.get(path, (None, -1))
        if cap is None:
            while len(store) >= self.max_per_thread:
                old_cap, _ = store.pop(next(iter(store)))  # oldest insertion
                old_cap.release()
            cap = cv2.VideoCapture(path)
            pos = 0
        if pos != start:
            cap.set(cv2.CAP_PROP_POS_FRAMES, start)
            pos = start
        frames: List[np.ndarray] = []
        for _ in range(length):
            ok, frame = cap.read()
            if not ok:
                break
            pos += 1
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        store[path] = (cap, pos)
        if not frames and length > 0:
            raise RuntimeError(
                f"could not decode any frame of window [{start}, {start + length}) "
                f"from {path}; the container's frame count appears to "
                f"overstate the decodable stream"
            )
        while len(frames) < length:
            frames.append(frames[-1])
        return frames


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
        self._caps = _CaptureCache()
        self._cache: Dict[Source, np.ndarray] = {}

    def _cache_limit_bytes(self) -> int:
        return int(os.environ.get("VAD_FRAME_CACHE_BYTES", 4 * 1024**3))

    def _decode_source(self, src: Source, n_frames: int) -> np.ndarray:
        """The first ``n_frames`` frames of ``src`` as uint8 [N, H, W, 3]."""
        if isinstance(src, str):
            raw = self._caps.read_window(src, 0, n_frames)
            return np.stack([resize_u8(f, self.image_size) for f in raw])
        with ThreadPoolExecutor(max_workers=4) as pool:
            return np.stack(list(pool.map(lambda p: _load_u8(p, self.image_size), src)))

    def _build_frame_cache(self) -> None:
        """Decode every distinct source once into uint8 [N, H, W, 3], the
        sources in parallel (the per-thread capture stores keep handles
        apart)."""
        if not self.cache_frames or not self.windows:
            return
        need: Dict[Source, int] = {}  # frames per source: furthest start + T
        for w in self.windows:
            if isinstance(w.source, str):
                need[w.source] = max(need.get(w.source, 0), w.start + self.sequence_length)
            else:
                need.setdefault(w.source, len(w.source))
        if sum(need.values()) * self.image_size * self.image_size * 3 > self._cache_limit_bytes():
            self.cache_frames = False
            return
        workers = max(1, min(len(need), os.cpu_count() or 1, 8))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            arrays = pool.map(lambda src: self._decode_source(src, need[src]), need)
            self._cache.update(zip(need, arrays))

    def __len__(self) -> int:
        return len(self.windows)

    def close(self) -> None:
        """Release decoder handles and the frame cache (safe to repeat; the
        dataset stays usable, handles reopen lazily)."""
        self._caps.close()
        self._cache.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    @property
    def labels(self) -> np.ndarray:
        return np.array([w.label for w in self.windows], dtype=np.int64)

    @property
    def has_frame_labels(self) -> bool:
        return any(w.frame_labels is not None for w in self.windows)

    def _decode_u8(self, w: Window) -> np.ndarray:
        """uint8 [T, H, W, 3] window frames (cache hit = memory slice)."""
        cached = self._cache.get(w.source)
        if cached is not None:
            return cached[w.start : w.start + self.sequence_length]
        if isinstance(w.source, str):
            raw = self._caps.read_window(w.source, w.start, self.sequence_length)
            return np.stack([resize_u8(f, self.image_size) for f in raw])
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

    def _add_windows(self, source: Source, total: int, label: int, label_name: str,
                     video_id: str, frame_labels: Optional[np.ndarray]) -> None:
        for start in range(0, total - self.sequence_length + 1, self.stride):
            end = start + self.sequence_length
            fl = None
            win_label = label
            if frame_labels is not None:
                fl = np.asarray(frame_labels[start:end])
                win_label = int(np.any(fl == 1))  # anomalous iff ANY frame is
            self.windows.append(Window(source, start, win_label, label_name, video_id, fl))


def _frame_paths(folder: Path) -> Tuple[str, ...]:
    return tuple(str(f) for f in sorted(folder.iterdir()) if f.suffix.lower() in IMAGE_EXTS)


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
            paths = _frame_paths(video_folder)
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
            self._add_windows(paths, len(paths), 0, "normal", vid, frame_labels)
        self._build_frame_cache()


class VideoDataset(_WindowDataset):
    """Generic ``<cat>/<split>/<label_folder>/`` dataset of video files or
    frame folders; label 0 iff the folder is one of ``NORMAL_FOLDERS``."""

    NORMAL_FOLDERS = ("good", "normal", "train")

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
        split_dir = Path(root_dir) / category / split
        if not split_dir.exists():
            raise FileNotFoundError(f"Dataset not found at {split_dir}")
        for label_folder in sorted(split_dir.iterdir()):
            if not label_folder.is_dir():
                continue
            name = label_folder.name
            label = 0 if name in self.NORMAL_FOLDERS else 1
            for entry in sorted(label_folder.iterdir()):
                if entry.suffix.lower() in VIDEO_EXTS:
                    total = self._probe_video(str(entry))
                    self._add_windows(str(entry), total, label, name, entry.stem, None)
                elif entry.is_dir():
                    paths = _frame_paths(entry)
                    self._add_windows(paths, len(paths), label, name, entry.name, None)
        self._build_frame_cache()

    @staticmethod
    def _probe_video(path: str) -> int:
        cv2 = cv2_module()
        cap = cv2.VideoCapture(path)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        return total


class VideoFileDataset(_WindowDataset):
    """Stride-S windows over one video file, for inference on uploads.

    Samples carry normalized ``frames`` and, with ``return_original``, the
    raw uint8 ``original_frames`` (resized to ``image_size``) for overlays."""

    def __init__(
        self,
        video_path: str,
        sequence_length: int = 16,
        stride: int = 1,
        image_size: int = 256,
        return_original: bool = True,
    ) -> None:
        super().__init__(sequence_length, stride, image_size, cache_frames=False)
        self.video_path = str(video_path)
        self.return_original = return_original
        cv2 = cv2_module()
        cap = cv2.VideoCapture(self.video_path)
        self.total_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        cap.release()
        self._add_windows(self.video_path, self.total_frames, 0, "normal",
                          Path(video_path).stem, None)

    def __getitem__(self, idx: int) -> Dict:
        w = self.windows[idx]
        raw = self._caps.read_window(w.source, w.start, self.sequence_length)
        sample = {
            "frames": np.stack([_normalize_frame(f, self.image_size) for f in raw]),
            "start_frame": np.int64(w.start),
        }
        if self.return_original:
            sample["original_frames"] = np.stack([resize_u8(f, self.image_size) for f in raw])
        return sample


def detect_video_dataset_class(root_dir: str, category: str):
    """``IPADDataset`` iff ``<cat>/training/frames`` exists, else
    ``VideoDataset`` (the generic layout)."""
    if (Path(root_dir) / category / "training" / "frames").exists():
        return IPADDataset
    return VideoDataset


def get_video_dataloaders(
    root_dir: str,
    category: str,
    sequence_length: int = 16,
    stride: int = 4,
    batch_size: int = 8,
    image_size: int = 256,
    num_workers: int = 4,
    device=None,
):
    """Train and test loaders (the train one shuffled, seed 0).  Frames
    stay uint8 and go to ``device`` (``None`` means CUDA), where the
    trainer normalizes them; batches are ``(batch, n_real)``."""
    from vad_tpu_torch.data.loader import DistributedLoader

    cls = detect_video_dataset_class(root_dir, category)
    common = dict(sequence_length=sequence_length, stride=stride, image_size=image_size,
                  normalize=False)
    train = cls(root_dir, category, "train", **common)
    test = cls(root_dir, category, "test", **common)
    return (
        DistributedLoader(train, batch_size, shuffle=True, num_workers=num_workers, seed=0,
                          device=device),
        DistributedLoader(test, batch_size, num_workers=num_workers, device=device),
    )
