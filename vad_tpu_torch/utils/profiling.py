"""Run metrics as JSON lines (the JAX package's ``MetricsLogger`` without
its TensorBoard writer)."""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np


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
