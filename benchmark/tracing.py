"""The traced run: ``torch.profiler`` over the measured window, summarised
in process (no trace file is written).

The benchmark's own spans (``Tracer.span``), on the host clock from any
thread, bracket its calls into the program; they label the device's idle
gaps by what the host was doing.  ``Tracer.annotate`` brackets a module's
forward and backward with a named range, so device time can be attributed
to the kernels launched inside it (``Trace.device_s_under``).

Device activity comes from the profiler's kernel, memcpy and memset
records.  Busy time is the union of their intervals, clipped to the
window, so work on two streams at once counts once.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

WINDOW = "bench.window"
OUTSIDE = "no span"  # idle gaps while none of the benchmark's spans was open


class Tracer:
    """Spans and the profiler; every method is free when ``enabled`` is off."""

    def __init__(self, enabled: bool, default_label: str = OUTSIDE) -> None:
        self.enabled, self.default_label = enabled, default_label
        self._prof = None
        self._window = None
        self._window_ns = None
        # (name, start, end) on the host clock, from any thread: the profiler
        # keeps ranges of the thread that started it only
        self.spans: List[Tuple[str, int, int]] = []
        self.trace: Optional[Trace] = None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        start = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, start, time.time_ns()))  # list.append is atomic

    def start(self) -> None:
        """Start the profiler (before the window: its start-up is set-up)."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()

    def window_open(self) -> None:
        if self.enabled:
            import torch

            self._window = torch.profiler.record_function(WINDOW)
            self._window.__enter__()
            self._window_ns = time.time_ns()

    def window_close(self) -> None:
        if self.enabled and self._window is not None:
            self._window.__exit__(None, None, None)
            self._window = None

    def stop(self) -> None:
        if not self.enabled or self._prof is None:
            return
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.trace = Trace(self._prof, self.default_label, self.spans, self._window_ns)
        self._prof = None

    def annotate(self, module, name: str) -> None:
        """Bracket ``module``'s forward and backward with ``record_function``
        ranges named ``name`` (only when tracing)."""
        if not self.enabled:
            return
        import torch

        stack: List = []

        def enter(*_):
            stack.append(torch.profiler.record_function(name).__enter__())

        def leave(*_):
            stack.pop().__exit__(None, None, None)

        module.register_forward_pre_hook(enter)
        module.register_forward_hook(lambda *a: leave())
        module.register_full_backward_pre_hook(enter)
        module.register_full_backward_hook(lambda *a: leave())


def _end_ns(event) -> int:
    return event.end_ns() if hasattr(event, "end_ns") else event.start_ns() + event.duration_ns()


def _kind(event, names: set) -> Optional[str]:
    """'kernel', 'memcpy', 'memset' for device activity, else None."""
    kind = event.activity_type() if hasattr(event, "activity_type") else None
    name = event.name()
    if kind is not None:
        return {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}.get(kind)
    if str(event.device_type()) != "DeviceType.CUDA" or name in names:
        return None
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def union_length(intervals: np.ndarray) -> float:
    """Total length covered by ``[start, end]`` rows (overlaps once)."""
    if len(intervals) == 0:
        return 0.0
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    # a new run starts where an interval begins after everything before it ended
    starts_new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    run_id = np.cumsum(starts_new) - 1
    run_start = iv[starts_new, 0]
    run_end = np.zeros(run_start.shape)
    np.maximum.at(run_end, run_id, iv[:, 1])
    return float(np.sum(run_end - run_start))


def gaps(intervals: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """``[start, end]`` rows of the parts of [lo, hi] that no interval covers."""
    if len(intervals) == 0:
        return np.array([[lo, hi]])
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    starts = np.concatenate([[lo], ends])
    stops = np.concatenate([iv[:, 0], [hi]])
    keep = stops > starts
    return np.stack([starts[keep], stops[keep]], axis=1)


def labels_at(spans: Sequence[Tuple[str, float, float]], times: np.ndarray,
              default: str) -> List[str]:
    """For each of ``times``, the span that started last before it if it is
    still open then, else ``default`` (the benchmark's spans follow one
    another; they do not nest)."""
    spans = sorted(spans, key=lambda s: s[1])
    starts = np.array([s[1] for s in spans])
    ends = np.array([s[2] for s in spans])
    idx = np.searchsorted(starts, times, side="right") - 1
    return [spans[i][0] if i >= 0 and t < ends[i] else default for i, t in zip(idx, times)]


class Trace:
    """What one profiled window recorded, in seconds."""

    def __init__(self, prof, default_label: str = OUTSIDE, spans=(), window_ns: int = 0) -> None:
        self._prof = prof
        self.default_label = default_label
        events = prof.profiler.kineto_results.events()
        annotations = [e for e in events if str(e.device_type()) == "DeviceType.CPU"
                       and getattr(e, "is_user_annotation", lambda: False)()]
        if not annotations:  # older records: user annotations by activity name
            annotations = [e for e in events if str(e.device_type()) == "DeviceType.CPU"
                           and hasattr(e, "activity_type")
                           and e.activity_type() == "user_annotation"]
        names = {e.name() for e in annotations}
        window = [e for e in annotations if e.name() == WINDOW]
        if not window:
            raise RuntimeError("the profiled run holds no window span")
        base = window[0].start_ns()  # times are seconds from the window's start

        def sec(ns: int) -> float:
            return (ns - base) * 1e-9

        self.lo, self.hi = 0.0, sec(_end_ns(window[0]))
        # host spans: their clock meets the profiler's where the window opened
        self.spans = [(name, (s - window_ns) * 1e-9, (e - window_ns) * 1e-9)
                      for name, s, e in spans]
        rows = []
        for e in events:
            kind = _kind(e, names)
            if kind is None:
                continue
            s, t = max(sec(e.start_ns()), self.lo), min(sec(_end_ns(e)), self.hi)
            if t > s:
                rows.append((e.name(), kind, s, t))
        self.names = [r[0] for r in rows]
        self.kinds = np.array([r[1] for r in rows])
        self.iv = np.array([(r[2], r[3]) for r in rows]).reshape(-1, 2)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def _select(self, kinds: Iterable[str]) -> np.ndarray:
        return np.isin(self.kinds, list(kinds)) if len(self.kinds) else np.zeros(0, bool)

    def busy_s(self, kinds=("kernel", "memcpy", "memset")) -> float:
        return union_length(self.iv[self._select(kinds)])

    def idle_percent(self) -> Optional[float]:
        """The share of the window in which no kernel ran, in %."""
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s(kinds=("kernel",)) / self.window_s)

    def device_s(self, substrings: Sequence[str], kinds=("kernel",)) -> Tuple[float, int]:
        """(seconds, count) of device activity whose name contains one of
        ``substrings``."""
        sel = self._select(kinds)
        total, count = 0.0, 0
        for i in np.flatnonzero(sel):
            name = self.names[i]
            if any(s in name for s in substrings):
                total += self.iv[i, 1] - self.iv[i, 0]
                count += 1
        return total, count

    def device_s_under(self, annotation: str) -> Tuple[float, int]:
        """(seconds, ranges) of kernel time launched inside the ranges named
        ``annotation`` (the profiler's own attribution of kernels to the
        operators that launched them, summed under each range)."""
        total, count = 0.0, 0
        for e in self._prof.events():
            if e.name == annotation and str(e.device_type) == "DeviceType.CPU":
                total += e.device_time_total * 1e-6
                count += 1
        return total, count

    def top_ops(self, n: int = 10) -> List[list]:
        """The device operations that took most time: ``[name, seconds]``."""
        acc: Dict[str, float] = {}
        for name, (s, t) in zip(self.names, self.iv):
            acc[name] = acc.get(name, 0.0) + (t - s)
        top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], seconds] for name, seconds in top]

    def idle_gaps(self, n: int = 10, kinds=("kernel",)) -> List[list]:
        """The window's gaps with no kernel running, summed by the
        benchmark span open at each gap's middle: ``[label x count,
        seconds]``, the largest first."""
        acc: Dict[str, List[float]] = {}
        idle = gaps(self.iv[self._select(kinds)], self.lo, self.hi)
        labels = labels_at(self.spans, idle.mean(axis=1), self.default_label)
        for (s, t), label in zip(idle, labels):
            entry = acc.setdefault(label, [0, 0.0])
            entry[0] += 1
            entry[1] += t - s
        top = sorted(acc.items(), key=lambda kv: -kv[1][1])[:n]
        return [[f"{label} x{count}", seconds] for label, (count, seconds) in top]
