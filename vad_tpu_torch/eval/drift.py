"""Online score-distribution drift monitoring for the serving daemon, and
the training-time score summary checkpoints carry (a copy of the JAX
package's numpy-only ``vad_tpu/eval/drift.py``).

The calibrated threshold (p99 of held-out normal scores) promises that
~1% of NORMAL traffic is flagged.  ``ScoreWindow`` keeps a bounded ring of
the most recent scores of one served model (O(window) memory, O(chunk)
updates on the scoring path) and compares, on demand, the observed
exceedance rate with that contract (``drifting`` when the window is warm
and the rate is ``factor`` x the expected one) and the window's median
with the checkpoint's ``score_baseline`` (a shift visible even when scores
drift below the threshold).  The daemon surfaces both at ``GET
/v1/metrics`` and, with ``--alert-url``, as a ``score_drift`` webhook.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np


class ScoreWindow:
    """Thread-safe bounded ring of recent scores + drift verdicts.

    ``threshold`` / ``baseline`` are swappable after construction
    (checkpoint hot-reload re-calibrates the monitor without dropping
    the window — see ScoringService.reload).
    """

    def __init__(
        self,
        window: int = 4096,
        threshold: Optional[float] = None,
        baseline: Optional[dict] = None,
        expected_exceed: float = 0.01,
        factor: float = 5.0,
        min_count: int = 256,
    ) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self.expected_exceed = float(expected_exceed)
        self.factor = float(factor)
        # a window smaller than min_count could otherwise NEVER warm up
        # (filled <= window), silently disabling the verdict forever
        self.min_count = min(int(min_count), self.window)
        self._lock = threading.Lock()
        self._buf = np.zeros(self.window, np.float64)
        self._idx = 0          # next write position
        self._filled = 0       # valid entries (<= window)
        self._total = 0        # lifetime scores observed
        self._exceed_in_window = 0  # O(1) maintained exceedance count
        self._threshold = threshold
        self._baseline = baseline or None

    # ------------------------------------------------------------ config

    def recalibrate(self, threshold: Optional[float],
                    baseline: Optional[dict]) -> None:
        """Swap the calibration contract (checkpoint hot-reload).  The
        window itself is kept — the live traffic didn't change — but the
        exceedance count is rebuilt against the new threshold."""
        with self._lock:
            self._threshold = threshold
            self._baseline = baseline or None
            if threshold is None:
                self._exceed_in_window = 0
            else:
                valid = self._buf[: self._filled]
                self._exceed_in_window = int(np.sum(valid > threshold))

    # ------------------------------------------------------------ update

    def observe(self, scores) -> None:
        """Append one chunk's scores (scoring path: O(len(scores)),
        no quantiles, one lock)."""
        s = np.asarray(scores, np.float64).ravel()
        observed = s.size
        if observed == 0:
            return
        if observed >= self.window:
            s = s[-self.window:]
        n = s.size
        with self._lock:
            # threshold read under the same lock recalibrate() swaps it
            # with, so the count update can't straddle a re-anchoring
            thr = self._threshold
            self._total += int(observed)
            # entries about to be overwritten leave the exceedance count
            if thr is not None:
                end = self._idx + n
                if self._filled == self.window:
                    if end <= self.window:
                        old = self._buf[self._idx:end]
                    else:
                        old = np.concatenate(
                            [self._buf[self._idx:], self._buf[: end - self.window]]
                        )
                elif end > self.window:
                    # partial fill wrapping: positions [idx, window) are
                    # still empty, but the wrapped prefix holds the
                    # OLDEST valid entries and is about to be replaced
                    old = self._buf[: end - self.window]
                else:
                    old = None  # appending into empty tail only
                if old is not None and old.size:
                    self._exceed_in_window -= int(np.sum(old > thr))
                self._exceed_in_window += int(np.sum(s > thr))
            end = self._idx + n
            if end <= self.window:
                self._buf[self._idx:end] = s
            else:
                k = self.window - self._idx
                self._buf[self._idx:] = s[:k]
                self._buf[: end % self.window] = s[k:]
            self._idx = end % self.window
            self._filled = min(self.window, self._filled + n)

    # ----------------------------------------------------------- verdict

    def exceed_rate(self) -> Optional[float]:
        """Observed fraction of the window above the threshold (None
        until any scores arrive or without a threshold)."""
        with self._lock:
            if self._threshold is None or self._filled == 0:
                return None
            return self._exceed_in_window / self._filled

    def drifting(self) -> bool:
        """True iff the window is warm AND the exceedance contract is
        broken by >= ``factor``.  O(1): uses the maintained count."""
        with self._lock:
            if self._threshold is None or self._filled < self.min_count:
                return False
            rate = self._exceed_in_window / self._filled
        return rate >= self.factor * self.expected_exceed

    def snapshot(self) -> dict:
        """Distribution summary for GET /v1/metrics.  Quantiles are
        computed here, over the bounded window only — never on the
        scoring path."""
        with self._lock:
            valid = self._buf[: self._filled].copy()
            total = self._total
            thr = self._threshold
            base = self._baseline
            exceed = self._exceed_in_window
        out: dict = {
            "window": self.window,
            "count": int(valid.size),
            "total_observed": int(total),
        }
        q50 = None
        if valid.size:
            q50, q90, q99 = np.quantile(valid, [0.5, 0.9, 0.99])
            out.update(
                mean=float(valid.mean()),
                std=float(valid.std()),
                p50=float(q50),
                p90=float(q90),
                p99=float(q99),
            )
        if thr is not None:
            out["threshold"] = float(thr)
            out["expected_exceed_rate"] = self.expected_exceed
            if valid.size:
                rate = exceed / valid.size
                out["exceed_rate"] = round(float(rate), 6)
                out["drifting"] = bool(
                    valid.size >= self.min_count
                    and rate >= self.factor * self.expected_exceed
                )
        if base and q50 is not None:
            # median shift in units of the baseline's p99-p50 spread: a
            # scale-free "how far did typical traffic move" indicator
            # that catches downward drift exceedance cannot see
            spread = float(base.get("p99", 0.0)) - float(base.get("p50", 0.0))
            if spread > 0:
                out["baseline_p50"] = float(base["p50"])
                out["p50_shift"] = round(
                    (float(q50) - float(base["p50"])) / spread, 4
                )
        return out


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
