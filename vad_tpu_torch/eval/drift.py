"""Training-time score distribution summary (a copy of the JAX package's
numpy-only ``score_baseline``, ``vad_tpu/eval/drift.py``)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def score_baseline(scores) -> Optional[dict]:
    """Summary of held-out NORMAL scores stored in checkpoints, the serving
    drift monitor's comparison anchor (frame granularity for video).
    None when there are no normal scores."""
    s = np.asarray(list(scores), np.float64)
    if s.size == 0:
        return None
    q50, q90, q99 = np.quantile(s, [0.5, 0.9, 0.99])
    return {
        "count": int(s.size),
        "mean": float(s.mean()),
        "std": float(s.std()),
        "p50": float(q50),
        "p90": float(q90),
        "p99": float(q99),
    }
