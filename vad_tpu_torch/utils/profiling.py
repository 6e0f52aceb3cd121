"""Tracing, timing and metrics (the JAX package's
``vad_tpu/utils/profiling.py``), the device-memory report the daemon's
health shows, and the timing helper and peak rates the port's measuring
tools share.

- ``trace(logdir)``: ``torch.profiler`` over the block (CPU and, where
  there is a card, CUDA activities), written into ``logdir`` as a Chrome
  trace (``*.pt.trace.json``, for Perfetto or ``chrome://tracing``;
  ``tensorboard_trace_handler`` writes it without the tensorboard
  package);
- ``span(name)``: a named range of the program's own, recorded only while
  ``torch.profiler`` records (``trace``, or any other profiler the caller
  runs) and then on the clock of the device activities; otherwise one
  shared no-op context, for the cost of one flag check.  The profiler
  keeps the ranges of the thread that started it (and of autograd's
  backward, which it follows): on any other thread a span is a no-op;
- ``StepTimer``: wall-clock step timing with a percentile summary (the
  caller synchronizes the device before ``stop``);
- ``MetricsLogger``: append-only JSONL metrics per run directory, with an
  optional TensorBoard tee (``tensorboard=True``);
- ``TensorBoardWriter``: scalar event files through tensorboard's own
  ``EventFileWriter`` and protos; without the tensorboard package it is a
  no-op after one printed line, as in the JAX package;
- ``enable_nan_debugging()``: autograd's anomaly mode (a backward that
  makes a NaN raises, naming the forward op); the train step's
  ``debug_nans`` also checks each step's loss and raises
  ``FloatingPointError``, what ``jax_debug_nans`` makes a NaN step do.

The spans, named ``vad.<layer>.<what>``; each nests in the one that
caused it, and the outer span of a chunk or a step stands for that call:

- ``vad.scorer.chunk``: ``eval/serving.py`` ``MultiStreamScorer.score_chunk``,
  one a chunk; it holds, in turn,
  - ``vad.scorer.h2d``: the frames' and the mask's copy to the device
    (from pageable memory, synchronous),
  - ``vad.scorer.step``: the host issuing the chunk's step, up to the
    scores' readback (which is left unspanned);
- ``vad.model.encoder``, ``vad.model.decoder``: ``models/video_autoencoder.py``
  ``VideoEncoder.forward`` (blocks 2-4 after the fused input block) and
  ``VideoDecoder.forward``, wherever they run; in ``models/memae.py``
  ``MemAutoencoder.forward`` its 3-D encoder and decoder (the decoder's
  span holds the cast of the memory's read to the convolutions' type);
- ``vad.model.memory``: ``MemAutoencoder.forward``'s memory, the float32
  addressing and read between the two;
- ``vad.train.step``: ``train/steps.py`` ``make_train_step``'s step, one a
  step; it holds, in turn,
  - ``vad.train.forward``: normalisation, forward, the per-sample loss
    and its masked sum (one a microbatch),
  - ``vad.train.backward``: ``.backward()`` (one a microbatch); its kernels
    are launched from autograd's thread while the caller waits inside it,
  - ``vad.train.optimizer``: ``optimizer.step()``.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

# Dense peaks per card (data sheets): bf16 tensor-core FLOP/s, f32 FLOP/s
# outside the tensor cores, memory bytes/s.
DEVICE_PEAKS = {
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H100 NVL": (835e12, 60e12, 3.9e12),
    "H100": (989e12, 67e12, 3.35e12),  # SXM, also the fallback
}


# Dense TF32 tensor-core FLOP/s per ``DEVICE_PEAKS`` row (data sheets: half
# the bf16 rate).  f32-accurate work on the tensor cores takes three TF32
# products a multiply-add (3xTF32, the stepwise_tc recurrence design), so
# its least time is 3 x FLOP / this rate.
TF32_PEAKS = {"H100 PCIe": 378e12, "H100 NVL": 417.5e12, "H100": 494.7e12}


def device_peaks(name: str) -> Tuple[str, float, float, float]:
    """(row of ``DEVICE_PEAKS``, bf16 FLOP/s, f32 FLOP/s, bytes/s) for a
    card named ``name`` (``torch.cuda.get_device_name``)."""
    for key, val in DEVICE_PEAKS.items():
        if key in name:
            return (key, *val)
    return ("H100", *DEVICE_PEAKS["H100"])


def tf32_peak(name: str) -> float:
    """Dense TF32 tensor-core FLOP/s of the card named ``name``, from the
    ``DEVICE_PEAKS`` row ``device_peaks`` picks."""
    return TF32_PEAKS[device_peaks(name)[0]]


def device_memory_report(device=None) -> Optional[Dict[str, float]]:
    """Live memory of a CUDA device (``None``: the current one) from the
    caching allocator, in GiB, under the JAX package's keys: ``in_use_gib``
    and ``peak_gib`` (tensors allocated now and at most), ``limit_gib`` (the
    card's total).  None on the CPU, so callers print nothing."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    gib = 1024**3
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"in_use_gib": round(stats.get("allocated_bytes.all.current", 0) / gib, 3),
            "peak_gib": round(stats.get("allocated_bytes.all.peak", 0) / gib, 3),
            "limit_gib": round(total / gib, 3)}


def format_memory_report(mem: Optional[Dict[str, float]]) -> Optional[str]:
    """One human line from ``device_memory_report()``, or None."""
    if not mem:
        return None
    parts = [f"{label} {mem[key]:.2f} GiB" for key, label in (
        ("peak_gib", "peak"), ("in_use_gib", "in use"), ("limit_gib", "limit")) if key in mem]
    return "HBM: " + ", ".join(parts) if parts else None


def time_ms(fn: Callable[[], object], device: torch.device | str = "cuda", iters: int = 20,
            warmup: int = 3) -> float:
    """Mean time of ``fn()`` in ms over ``iters`` calls after ``warmup``:
    CUDA events on a CUDA device (device time), the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        start = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - start) / iters * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


_NO_SPAN = contextlib.nullcontext()  # reusable and reentrant: shared by every span when off


def span(name: str):
    """A ``record_function(name)`` range while the profiler records on this
    thread, else the shared no-op context (module docstring)."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(logdir: str | Path) -> Iterator[None]:
    """Profile the enclosed block into ``logdir`` (a Chrome trace per call)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))):
        yield


def enable_nan_debugging(enable: bool = True) -> torch.autograd.set_detect_anomaly:
    """Turn autograd's anomaly mode on or off; used as a context manager,
    the returned object restores the previous mode at exit."""
    return torch.autograd.set_detect_anomaly(enable)


class StepTimer:
    """Collects per-step wall times; summarizes mean/p50/p95."""

    def __init__(self) -> None:
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() before start()")
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        self._t0 = None
        return dt

    @contextlib.contextmanager
    def step(self) -> Iterator[None]:
        self.start()
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"count": 0}
        arr = np.asarray(self.times)
        return {"count": len(arr), "mean_s": float(arr.mean()),
                "p50_s": float(np.percentile(arr, 50)), "p95_s": float(np.percentile(arr, 95)),
                "total_s": float(arr.sum())}


class TensorBoardWriter:
    """Scalar-only TensorBoard event writer over tensorboard's
    ``EventFileWriter`` and summary protos.  Without the tensorboard
    package it prints one line and does nothing: training never depends
    on it."""

    def __init__(self, logdir: str | Path) -> None:
        self._writer = self._event_pb2 = self._summary_pb2 = None
        try:
            from tensorboard.compat.proto import event_pb2, summary_pb2
            from tensorboard.summary.writer.event_file_writer import EventFileWriter
        except ImportError as exc:
            print(f"TensorBoard unavailable ({exc}); scalar logging disabled")
            return
        Path(logdir).mkdir(parents=True, exist_ok=True)
        self._writer = EventFileWriter(str(logdir))
        self._event_pb2, self._summary_pb2 = event_pb2, summary_pb2

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is None:
            return
        summary = self._summary_pb2.Summary(
            value=[self._summary_pb2.Summary.Value(tag=tag, simple_value=float(value))])
        self._writer.add_event(
            self._event_pb2.Event(wall_time=time.time(), step=int(step), summary=summary))

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class MetricsLogger:
    """Append-only JSONL metrics next to the run's checkpoints.

    With ``tensorboard=True`` every numeric metric is also a TensorBoard
    scalar under ``<run_dir>/tb/``, flushed per call, so a live
    ``tensorboard --logdir results/`` follows the run."""

    def __init__(self, run_dir: str | Path, tensorboard: bool = False) -> None:
        self.path = Path(run_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.tb: Optional[TensorBoardWriter] = (
            TensorBoardWriter(Path(run_dir) / "tb") if tensorboard else None)

    def log(self, step: int, **metrics) -> None:
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            record[k] = float(v) if isinstance(v, (int, float, np.floating)) else v
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self.tb is not None:
            for k, v in record.items():
                if k not in ("step", "time") and isinstance(v, (int, float)) \
                        and not isinstance(v, bool):
                    self.tb.scalar(k, v, step)
            self.tb.flush()

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()
