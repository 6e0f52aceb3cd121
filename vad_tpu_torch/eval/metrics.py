"""Anomaly-decision thresholds (a copy of the JAX package's numpy-only
``calibrate_threshold``, ``vad_tpu/eval/metrics.py``)."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def calibrate_threshold(normal_scores: Sequence[float], quantile: float = 0.99) -> float | None:
    """Anomaly-decision threshold from held-out NORMAL scores only: their
    ``quantile`` (p99: ~1% false positives on normal data, whatever the
    model, category or loss scale).  None when there are no normal scores."""
    s = np.asarray(list(normal_scores), np.float64)
    if s.size == 0:
        return None
    return float(np.quantile(s, quantile))
