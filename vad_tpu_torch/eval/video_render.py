"""Streaming long-video scoring and the annotated video (the JAX package's
``vad_tpu/eval/video_render.py``).

A video streams through the model in chunks of ``chunk`` frames with the
ConvLSTM (h, c) carried across chunk boundaries, one continuous
recurrence over the whole video: every frame is decoded, scored and
written once.  The host pipeline has two stages, each on its own thread:

- decode (``iter_video_chunks``): a frame source to uint8 chunks, the
  last short chunk padded by repeating its last frame (``n_valid`` counts
  the real ones).  A source is a video file read with OpenCV, or any
  iterable of RGB uint8 frames.  This thread never touches CUDA.
- transfer (``iter_device_chunks``, over any host stage
  ``device_transfers``): each chunk is copied into a freshly
  pinned host buffer and sent to the card with a non-blocking copy on the
  stage's own CUDA stream, so the copy overlaps the decode of the next
  chunk and the compute of the previous one.  The thread sets its device
  first.  A pinned buffer is taken per chunk, and PyTorch's caching host
  allocator hands it out again only after the copy that reads it has
  finished.  The consumer's stream waits on the copy's event before it
  reads the chunk, and the chunk is recorded on that stream, so the
  caching allocator does not give its memory to the next copy while the
  compute still reads it.  On the CPU the stage is a plain copy.

The annotated video has three panels (original | reconstruction | JET
error heatmap) over a score bar (the score against 0.01, green, orange,
red), plus ``score_timeline.png``.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.data.video_dataset import cv2_module, resize_u8
from vad_tpu_torch.eval.plots import plot_or_skip, plot_score_timeline
from vad_tpu_torch.eval.video_eval import create_heatmap, denormalize_u8
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
from vad_tpu_torch.train.steps import u8_normalize
from vad_tpu_torch.utils.precision import tf32_off
from vad_tpu_torch.utils.weights import load_flax_variables

FrameSource = Union[str, Path, Iterable[np.ndarray]]  # a video file, or RGB uint8 frames


def _background(items: Callable[[], Iterator], prefetch: int) -> Iterator:
    """Run the iterator ``items()`` on a daemon thread, at most
    ``prefetch`` items ahead of the consumer.  Its error is raised in the
    consumer; when the consumer stops, the thread stops at its next item."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def run() -> None:
        try:
            for item in items():
                if not put((True, item)):
                    return
        except BaseException as exc:  # noqa: BLE001 - raised in the consumer
            put((False, exc))
            return
        put((False, None))

    threading.Thread(target=run, daemon=True).start()
    try:
        while True:
            ok, item = q.get()
            if not ok:
                if item is not None:
                    raise item
                return
            yield item
    finally:
        stop.set()


def _decoded_frames(source: FrameSource, image_size: int) -> Iterator[np.ndarray]:
    """RGB uint8 frames of ``source`` at ``image_size``²."""
    if not isinstance(source, (str, Path)):
        for frame in source:
            yield resize_u8(np.asarray(frame, np.uint8), image_size)
        return
    cv2 = cv2_module()
    cap = cv2.VideoCapture(str(source))
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                return
            # resize before the BGR->RGB conversion: both are per-pixel host
            # work, so converting at the model's size is the cheaper order
            if frame.shape[:2] != (image_size, image_size):
                frame = cv2.resize(frame, (image_size, image_size),
                                   interpolation=cv2.INTER_LINEAR)
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    finally:
        cap.release()


def iter_video_chunks(source: FrameSource, chunk: int, image_size: int, prefetch: int = 2
                      ) -> Iterator[Tuple[np.ndarray, int]]:
    """(uint8 [chunk,H,W,3], n_valid) from a background decode thread;
    normalization happens on the device."""

    def chunks():
        buf = []
        for frame in _decoded_frames(source, image_size):
            buf.append(frame)
            if len(buf) == chunk:
                yield np.stack(buf), chunk
                buf = []
        if buf:
            n_valid = len(buf)
            buf += [buf[-1]] * (chunk - n_valid)
            yield np.stack(buf), n_valid

    return _background(chunks, prefetch)


def device_transfers(host_chunks: Callable[[], Iterator[Tuple[np.ndarray, int]]], device=None,
                     prefetch: int = 2) -> Iterator[Tuple[np.ndarray, torch.Tensor, int]]:
    """The transfer stage over any host stage: ``host_chunks()``, run on
    the transfer thread, yields (uint8 array, n_valid); this yields (the
    array, its copy on ``device``, n_valid).  ``device`` ``None`` means
    CUDA.  The device copy is ready for the consumer's current stream when
    it is yielded."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:  # the transfer thread sets it by index
        device = torch.device("cuda", torch.cuda.current_device())
    copy_stream = torch.cuda.Stream(device) if cuda else None

    def transfers():
        if not cuda:
            for raw, n_valid in host_chunks():
                yield raw, torch.from_numpy(raw.copy()), n_valid, None
            return
        torch.cuda.set_device(device)
        for raw, n_valid in host_chunks():
            host = torch.from_numpy(raw).pin_memory()
            with torch.cuda.stream(copy_stream):
                dev = host.to(device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(copy_stream)
            yield raw, dev, n_valid, done

    for raw, dev, n_valid, done in _background(transfers, prefetch):
        if done is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(done)
            dev.record_stream(stream)
        yield raw, dev, n_valid


def iter_device_chunks(source: FrameSource, chunk: int, image_size: int, device=None,
                       prefetch: int = 2) -> Iterator[Tuple[np.ndarray, torch.Tensor, int]]:
    """``iter_video_chunks`` plus the transfer stage (``device_transfers``):
    (uint8 [chunk,H,W,3] on the host, uint8 [1,chunk,H,W,3] on ``device``,
    n_valid).  ``device`` ``None`` means CUDA."""
    for raw, dev, n_valid in device_transfers(
            lambda: iter_video_chunks(source, chunk, image_size, prefetch), device, prefetch):
        yield raw, dev[None], n_valid


def stream_scores(
    model: VideoAutoencoder,
    variables,
    source: FrameSource,
    image_size: int,
    chunk: int = 16,
    on_frame=None,
    objective: str = "reconstruct",
) -> np.ndarray:
    """Score every frame of a video once, carrying the ConvLSTM state, on
    the model's device (eval mode, f32 with TF32 off on the card; the
    first block is the model's own, not the fused input block).

    ``variables`` (a JAX-layout tree) is loaded into ``model`` first unless
    None.  Returns per-frame scores [N].  ``on_frame(orig_u8, recon_u8,
    err_map, score)`` is called for each real frame if given.

    ``objective='predict'`` scores frame t against the model's output at
    t-1 (its prediction of frame t), carried across chunk boundaries; the
    first frame has no prediction and borrows frame 1's score."""
    if variables is not None:
        load_flax_variables(model, variables)
    model.eval()
    device = model.device
    predict = objective == "predict"
    states = model.zero_state(1, image_size, image_size)
    prev_pred = torch.zeros((1, 1, image_size, image_size, 3), device=device)
    scores: list[float] = []
    first_chunk = True
    with torch.no_grad(), tf32_off(device.type == "cuda"):
        for raw, dev, n_valid in iter_device_chunks(source, chunk, image_size, device):
            x = u8_normalize(dev)
            recon, err, frame_scores, states = model.stream_step(x, states)
            shown = recon
            if predict:
                shown = torch.cat([prev_pred, recon[:, :-1]], dim=1)
                err = torch.mean(torch.square(x - shown), dim=-1)
                frame_scores = torch.mean(err, dim=(2, 3))
            prev_pred = recon[:, -1:]
            fs = frame_scores[0, :n_valid].cpu().numpy()
            if predict and first_chunk and len(fs) > 1:
                fs[0] = fs[1]  # frame 0 has no prediction
            first_chunk = False
            scores.extend(fs.tolist())
            if on_frame is not None:
                shown_np, err_np = shown[0].cpu().numpy(), err[0].cpu().numpy()
                for t in range(n_valid):
                    on_frame(raw[t], denormalize_u8(shown_np[t]), err_np[t], float(fs[t]))
    return np.asarray(scores)


def compose_annotated_frame(orig_u8: np.ndarray, recon_u8: np.ndarray, err_map: np.ndarray,
                            score: float) -> np.ndarray:
    """Three panels over a 60-pixel score bar, RGB."""
    cv2 = cv2_module()
    heat = create_heatmap(err_map, size=orig_u8.shape[1::-1])
    combined = np.hstack([orig_u8, recon_u8, heat])
    w = combined.shape[1]
    bar = np.zeros((60, w, 3), dtype=np.uint8)
    score_norm = min(score / 0.01, 1.0)
    bar_width = int(score_norm * (w - 20))
    color = ((0, 255, 0) if score_norm < 0.5 else (255, 165, 0) if score_norm < 0.75
             else (255, 0, 0))
    cv2.rectangle(bar, (10, 20), (10 + bar_width, 50), color, -1)
    cv2.rectangle(bar, (10, 20), (w - 10, 50), (255, 255, 255), 2)
    cv2.putText(bar, f"Score: {score:.6f}", (10, 15), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                (255, 255, 255), 1)
    return np.vstack([combined, bar])


def generate_video_output(
    model: VideoAutoencoder,
    variables,
    video_path: str,
    output_path: str,
    image_size: int = 256,
    sequence_length: int = 16,
    fps: Optional[float] = None,
    objective: str = "reconstruct",
) -> np.ndarray:
    """The annotated mp4 and ``score_timeline.png`` (beside it) for one
    video; returns the per-frame scores."""
    cv2 = cv2_module()
    cap = cv2.VideoCapture(video_path)
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    if total < 1:
        print("Video too short for analysis")
        return np.zeros(0)

    writer = cv2.VideoWriter(str(output_path), cv2.VideoWriter_fourcc(*"mp4v"), fps or src_fps,
                             (image_size * 3, image_size + 60))
    print(f"Processing {total} frames (chunked, state-carrying stream)...")

    def on_frame(orig, recon, err, score):
        frame = compose_annotated_frame(orig, recon, err, score)
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))

    try:
        scores = stream_scores(model, variables, video_path, image_size, chunk=sequence_length,
                               on_frame=on_frame, objective=objective)
    finally:
        writer.release()
    print(f"Saved annotated video to: {output_path}")

    timeline_path = Path(output_path).parent / "score_timeline.png"
    if plot_or_skip(plot_score_timeline, scores, timeline_path):
        print(f"Saved score timeline to: {timeline_path}")
    return scores
