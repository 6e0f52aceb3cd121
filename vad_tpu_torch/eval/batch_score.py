"""Batch scoring of many videos through ``MultiStreamScorer`` slots (the
JAX package's ``vad_tpu/eval/batch_score.py``; ``evaluate_video --video-dir``).

Every video occupies one stream slot of a single scorer, so the card steps
on the full ``[num_slots, chunk, H, W, 3]`` batch: each video has its own
decode and transfer threads (``video_render.iter_device_chunks``), its
ConvLSTM (h, c) is carried across its chunks inside its slot, and when it
ends the slot goes to the next pending video.  The chunks arrive on the
card as uint8 and are gathered there into the batch, which the scorer
takes without a copy.  On the card the scorer runs the fused input block
(kernel 4) and the recurrence (kernel 1).
"""

from __future__ import annotations

import json
from collections import deque
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from vad_tpu_torch.eval.metrics import serving_frame_threshold
from vad_tpu_torch.eval.plots import plot_or_skip, plot_score_timeline
from vad_tpu_torch.eval.serving import MultiStreamScorer
from vad_tpu_torch.eval.video_eval import load_video_model
from vad_tpu_torch.eval.video_render import FrameSource, iter_device_chunks
from vad_tpu_torch.utils.checkpoint import load_checkpoint
from vad_tpu_torch.utils.precision import tf32_off

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv")


class _VideoFeed:
    """One video's chunk iterator and accumulated per-frame scores."""

    def __init__(self, name: str, source: FrameSource, chunk: int, image_size: int,
                 device: torch.device) -> None:
        self.name = name
        self.scores: List[float] = []
        self.error: Optional[str] = None
        self._chunks = iter_device_chunks(source, chunk, image_size, device)

    def next_chunk(self):
        """(device uint8 [1,chunk,H,W,3], n_valid), or None when the video
        has ended or failed to decode."""
        try:
            _, dev, n_valid = next(self._chunks)
        except StopIteration:
            return None
        except Exception as exc:  # a decode failure ends THIS video only
            self.error = str(exc)
            return None
        return dev, n_valid


def score_videos(
    model,
    variables,
    videos: Union[Sequence[str], Mapping[str, FrameSource]],
    image_size: int = 256,
    chunk: int = 16,
    num_slots: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    on_progress=None,
) -> Dict[str, dict]:
    """Score every frame of every video once, the videos batched over
    slots, on the model's device.

    ``videos``: video file paths, or {name: frame source} where a source is
    a path or an iterable of RGB uint8 frames.  Returns {name: {"scores":
    float64 [n_frames] or None, "error": str or None}}; a video that fails
    to decode reports its error without aborting the batch.

    ``num_slots`` defaults to min(number of videos, 16).  ``dtype`` is the
    scorer's compute type; f32 runs with TF32 off on the card.  A video's
    scores equal those of scoring it alone, within the f32 bar: slots never
    interact, and only the slots that submit a chunk advance their state."""
    if not isinstance(videos, Mapping):
        videos = {str(p): str(p) for p in videos}
    if not videos:
        return {}
    device = model.device
    slots_n = num_slots or min(len(videos), 16)
    scorer = MultiStreamScorer(model, variables, num_slots=slots_n, chunk=chunk,
                               image_size=image_size, dtype=dtype, device=device)
    pending = deque(videos.items())
    feeds: Dict[int, _VideoFeed] = {}
    results: Dict[str, dict] = {}
    batch = torch.zeros((slots_n, chunk) + scorer.image_hw + (3,), dtype=torch.uint8,
                        device=device)

    def finish(slot: int) -> None:
        feed = feeds.pop(slot)
        scorer.detach(slot)
        results[feed.name] = {
            "scores": None if feed.error else np.asarray(feed.scores, np.float64),
            "error": feed.error,
        }
        if on_progress is not None:
            on_progress(feed.name, results[feed.name])

    with tf32_off(dtype == torch.float32 and device.type == "cuda"):
        while pending or feeds:
            while pending and len(feeds) < slots_n:
                name, source = pending.popleft()
                feeds[scorer.attach()] = _VideoFeed(name, source, chunk, image_size, device)
            submitted = np.zeros(slots_n, bool)
            n_valids: Dict[int, int] = {}
            for slot, feed in list(feeds.items()):
                item = feed.next_chunk()
                if item is None:
                    finish(slot)
                    continue
                dev, n_valids[slot] = item
                batch[slot] = dev[0]  # on the card: the chunk never returns to the host
                submitted[slot] = True
            if not submitted.any():
                continue
            scores = scorer.score_chunk(batch, submitted=submitted)
            for slot, n_valid in n_valids.items():
                feeds[slot].scores.extend(float(s) for s in scores[slot, :n_valid])
    return results


def score_video_dir(
    checkpoint: str,
    video_dir: str,
    output_dir: Optional[str] = None,
    num_slots: Optional[int] = None,
    save_timelines: bool = True,
    device=None,
) -> dict:
    """Score every video file under ``video_dir`` (recursively) with the
    model in ``checkpoint`` on ``device`` (``None`` means CUDA); write
    ``batch_scores.json`` and a score-timeline PNG per video under
    ``output_dir`` (default ``<checkpoint dir>/batch_scoring/``).

    Frames are flagged against the checkpoint's calibrated
    ``frame_score_threshold`` when it is valid for reconstruction scores
    (``metrics.serving_frame_threshold``); without one, the raw scores are
    still reported.  Returns the summary (``batch_scores.json``'s content)."""
    root = Path(video_dir)
    paths = sorted(str(p) for p in root.rglob("*")
                   if p.is_file() and p.suffix.lower() in VIDEO_EXTENSIONS)
    if not paths:
        raise FileNotFoundError(f"no video files ({'/'.join(VIDEO_EXTENSIONS)}) under {video_dir}")
    model, variables, saved = load_video_model(checkpoint, device)
    threshold = serving_frame_threshold(load_checkpoint(checkpoint))
    image_size = int(saved.get("image_size", 256))
    chunk = int(saved.get("sequence_length", 16))

    out_dir = Path(output_dir) if output_dir else Path(checkpoint).parent / "batch_scoring"
    out_dir.mkdir(parents=True, exist_ok=True)
    print(f"Scoring {len(paths)} videos from {video_dir} "
          f"({min(num_slots or 16, len(paths))} concurrent slots)...")

    def on_progress(path: str, result: dict) -> None:
        if result["error"]:
            print(f"  FAILED {path}: {result['error']}")
        else:
            s = result["scores"]
            print(f"  scored {path}: {len(s)} frames, mean {s.mean():.6f}, max {s.max():.6f}"
                  if len(s) else f"  scored {path}: 0 frames")

    results = score_videos(model, None, paths, image_size=image_size, chunk=chunk,
                           num_slots=num_slots, on_progress=on_progress)

    summary = {"checkpoint": str(checkpoint), "video_dir": str(video_dir),
               "frame_score_threshold": threshold, "videos": {}}
    for path in paths:
        res = results[path]
        if res["error"] is not None:
            summary["videos"][path] = {"error": res["error"]}
            continue
        s = res["scores"]
        entry = {
            "frames": int(len(s)),
            "mean_score": float(s.mean()) if len(s) else None,
            "max_score": float(s.max()) if len(s) else None,
        }
        if threshold is not None and len(s):
            flagged = s > threshold
            entry["anomalous_frames"] = int(flagged.sum())
            entry["anomaly_ratio"] = float(flagged.mean())
        summary["videos"][path] = entry
        if save_timelines and len(s):
            plot_or_skip(plot_score_timeline, s, out_dir / f"{Path(path).stem}_timeline.png",
                         threshold=threshold)

    summary_path = out_dir / "batch_scores.json"
    summary_path.write_text(json.dumps(summary, indent=2))
    print(f"Saved batch summary to: {summary_path}")
    return summary
