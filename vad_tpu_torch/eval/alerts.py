"""Webhook alerting for the serving daemon (``python -m vad_tpu_torch.serve
--alert-url``): a copy of the JAX package's stdlib-and-numpy
``vad_tpu/eval/alerts.py``.

``AlertNotifier`` watches each stream's chunk scores and POSTs a JSON
alert when a stream stays anomalous for ``consecutive`` chunks:

    {"type": "stream_anomaly", "slot": 3, "consecutive_chunks": 3,
     "frames_flagged": 12, "max_score": 0.041, "threshold": 0.012,
     "timestamp": 1765432100.5}

It never blocks or fails the scoring path: observing only updates
counters and enqueues, delivery runs on its own daemon thread, and a
failed delivery is printed, counted and dropped.  A per-source
``cooldown`` suppresses repeats during a long anomaly; a clean chunk
resets the streak and a detach resets the slot.  ``notify`` carries other
payloads (the drift monitor's ``score_drift``) over the same channel.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import urllib.request
from typing import Dict

import numpy as np


class AlertNotifier:
    """Per-source streak tracking + async webhook delivery."""

    def __init__(self, url: str, consecutive: int = 3,
                 cooldown: float = 60.0, timeout: float = 10.0) -> None:
        if consecutive < 1:
            raise ValueError(f"consecutive must be >= 1, got {consecutive}")
        self.url = url
        self.consecutive = consecutive
        self.cooldown = cooldown
        self.timeout = timeout
        self._streak: Dict[object, int] = {}
        self._last_alert: Dict[object, float] = {}
        self._lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue()
        self.delivered = 0
        self.failed = 0
        self._worker = threading.Thread(target=self._deliver_loop, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ observe

    def observe(self, source, scores, threshold) -> None:
        """Feed one chunk's scores for ``source`` (a stream slot).  Called
        on the scoring path — does no I/O, only counter updates and a
        queue put."""
        if threshold is None:
            return
        scores = np.asarray(scores, np.float64)
        flagged = int(np.sum(scores > threshold))
        with self._lock:
            if flagged == 0:
                self._streak[source] = 0
                return
            self._streak[source] = self._streak.get(source, 0) + 1
            streak = self._streak[source]
            now = time.time()
            if streak < self.consecutive:
                return
            if now - self._last_alert.get(source, -1e18) < self.cooldown:
                return
            self._last_alert[source] = now
        self._queue.put({
            "type": "stream_anomaly",
            "slot": source,
            "consecutive_chunks": streak,
            "frames_flagged": flagged,
            "max_score": float(scores.max()),
            "threshold": float(threshold),
            "timestamp": now,
        })

    def notify(self, payload, source, cooldown: float | None = None) -> bool:
        """Enqueue an arbitrary alert payload (same async worker, never
        blocks the caller) under a per-``source`` cooldown — the channel
        the daemon's drift monitor rides (eval/drift.py: a broken
        exceedance contract is fleet-level, not a per-stream streak).
        ``payload`` may be a dict or a zero-arg callable returning one;
        a callable is only invoked when the cooldown is open, so callers
        on a hot path don't build (e.g. quantile-summarize) payloads the
        cooldown would discard.  Returns True iff enqueued."""
        cd = self.cooldown if cooldown is None else cooldown
        now = time.time()
        with self._lock:
            if now - self._last_alert.get(source, -1e18) < cd:
                return False
            self._last_alert[source] = now
        if callable(payload):
            payload = payload()
        self._queue.put({**payload, "timestamp": now})
        return True

    def reset(self, source) -> None:
        """Forget a source's streak/cooldown (stream detached)."""
        with self._lock:
            self._streak.pop(source, None)
            self._last_alert.pop(source, None)

    # ------------------------------------------------------------ deliver

    def _deliver_loop(self) -> None:
        while True:
            alert = self._queue.get()
            if alert is None:
                return
            try:
                req = urllib.request.Request(
                    self.url, data=json.dumps(alert).encode(),
                    headers={"Content-Type": "application/json"},
                )
                urllib.request.urlopen(req, timeout=self.timeout).read()
                self.delivered += 1
            except Exception as exc:  # drop, never back up the queue
                self.failed += 1
                print(f"alert: delivery to {self.url} failed: {exc}", flush=True)

    def close(self) -> None:
        self._queue.put(None)
        self._worker.join(timeout=5)
