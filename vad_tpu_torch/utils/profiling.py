"""Run metrics as JSON lines (the JAX package's ``MetricsLogger`` without
its TensorBoard writer), the device-memory report the daemon's health
shows, and the timing helper and peak rates the port's measuring tools
share."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

# Dense peaks per card (data sheets): bf16 tensor-core FLOP/s, f32 FLOP/s
# outside the tensor cores, memory bytes/s.
DEVICE_PEAKS = {
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H100 NVL": (835e12, 60e12, 3.9e12),
    "H100": (989e12, 67e12, 3.35e12),  # SXM, also the fallback
}


def device_peaks(name: str) -> Tuple[str, float, float, float]:
    """(row of ``DEVICE_PEAKS``, bf16 FLOP/s, f32 FLOP/s, bytes/s) for a
    card named ``name`` (``torch.cuda.get_device_name``)."""
    for key, val in DEVICE_PEAKS.items():
        if key in name:
            return (key, *val)
    return ("H100", *DEVICE_PEAKS["H100"])


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


class MetricsLogger:
    """Append-only JSONL metrics next to the run's checkpoints."""

    def __init__(self, run_dir: str | Path) -> None:
        self.path = Path(run_dir) / "metrics.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, step: int, **metrics) -> None:
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            record[k] = float(v) if isinstance(v, (int, float, np.floating)) else v
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
