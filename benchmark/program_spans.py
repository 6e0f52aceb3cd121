"""The program's own spans in a traced window, and the kernels launched
inside them.

The program names its spans ``vad.<layer>.<what>``
(``vad_tpu_torch/utils/profiling.py`` ``span``: ``record_function`` ranges
while the profiler records).  They are the profiler's own records, on the
clock of the device activities, so they need no alignment: times here are
seconds from the window's start, as in ``Trace``.

A kernel belongs to every span whose host interval holds its launch: the
start of the CUDA runtime or driver call that shares the kernel's
correlation id, on whatever thread it ran.  So the kernels of a backward,
launched from autograd's thread while the caller waits inside its span,
count in that span, and so does a kernel that runs after its span closed.
Where the profile holds no such call (one cuBLAS kernel a step of the f32
train step, on torch 2.11), the start of the operator that launched it
(the kernel's linked correlation id) stands for the launch.  Per-call
numbers count the spans that lie wholly inside the window.

A program without the spans (an older commit) yields none, and the
readers that use them return nothing.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np

from benchmark.tracing import WINDOW, _end_ns, _kind

PREFIX = "vad."
ROLES = {"user_annotation": "annotation", "cuda_runtime": "launch", "cuda_driver": "launch",
         "cpu_op": "op"}
LAUNCH_NAME = re.compile(r"^cuda?[A-Z]")  # cudaLaunchKernel, cuLaunchKernelEx, ...


def runs(intervals: np.ndarray) -> np.ndarray:
    """The union of ``[start, end]`` rows as disjoint rows, in order."""
    if len(intervals) == 0:
        return np.zeros((0, 2))
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    first = np.flatnonzero(np.concatenate([[True], iv[1:, 0] > ends[:-1]]))
    last = np.concatenate([first[1:] - 1, [len(iv) - 1]])
    return np.stack([iv[first, 0], ends[last]], axis=1)


def covered(cover: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """For each ``[lo, hi]``, how much of it the disjoint ordered rows
    ``cover`` cover."""
    if len(cover) == 0:
        return np.zeros(np.shape(lo))
    length = cover[:, 1] - cover[:, 0]
    before = np.concatenate([[0.0], np.cumsum(length)])

    def upto(t):  # covered length before time t
        k = np.searchsorted(cover[:, 0], t, side="right") - 1  # the last row begun by t
        j = np.maximum(k, 0)
        return np.where(k >= 0, before[j] + np.clip(t - cover[j, 0], 0.0, length[j]), 0.0)

    return upto(np.asarray(hi)) - upto(np.asarray(lo))


def holding(region: np.ndarray, lo: np.ndarray, hi: Optional[np.ndarray] = None) -> np.ndarray:
    """Which of the times ``lo`` fall in a row ``[start, end)`` of the
    disjoint ordered rows ``region``; with ``hi``, which intervals ``[lo,
    hi]`` lie wholly in one row."""
    if len(region) == 0:
        return np.zeros(np.shape(lo), bool)
    k = np.searchsorted(region[:, 0], lo, side="right") - 1
    end = region[np.maximum(k, 0), 1]
    return (k >= 0) & ((lo < end) if hi is None else (hi <= end))


class ProgramSpans:
    """The ``vad.*`` ranges of one window and the kernels of the run.

    ``ranges``: name -> ``[n, 2]`` (start, end); ``launch``, ``start``,
    ``end``: one entry a kernel (``launch`` NaN where neither its launch
    nor its operator was found: such a kernel belongs to no span); ``lo``,
    ``hi``: the window."""

    def __init__(self, ranges: Dict[str, np.ndarray], launch: np.ndarray, start: np.ndarray,
                 end: np.ndarray, lo: float, hi: float) -> None:
        self.ranges = {k: np.asarray(v, float).reshape(-1, 2) for k, v in ranges.items()}
        self.launch = np.asarray(launch, float)
        self.start, self.end = np.asarray(start, float), np.asarray(end, float)
        self.lo, self.hi = lo, hi

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def within(self, name: str, outer: Optional[str] = None) -> np.ndarray:
        """The spans ``name`` that lie wholly inside the window and, with
        ``outer``, inside a span ``outer`` that does."""
        iv = self.ranges.get(name, np.zeros((0, 2)))
        iv = iv[(iv[:, 0] >= self.lo) & (iv[:, 1] <= self.hi)]
        if outer is not None:
            iv = iv[holding(runs(self.within(outer)), iv[:, 0], iv[:, 1])]
        return iv

    def count(self, name: str) -> int:
        return len(self.within(name))

    def host_s(self, name: str, outer: Optional[str] = None) -> float:
        """Host seconds inside the spans ``name`` (``within``)."""
        iv = self.within(name, outer)
        return float(np.sum(iv[:, 1] - iv[:, 0]))

    def launched(self, name: str, outer: Optional[str] = None) -> Tuple[float, int]:
        """(device seconds, kernels) of the kernels launched inside the
        spans ``name`` (``within``)."""
        inside = holding(runs(self.within(name, outer)), self.launch)
        return float(np.sum(self.end[inside] - self.start[inside])), int(np.sum(inside))

    def idle_s(self, name: str) -> float:
        """Seconds of the window inside the spans ``name`` in which no
        kernel ran."""
        spans = np.clip(self.ranges.get(name, np.zeros((0, 2))), self.lo, self.hi)
        spans = runs(spans[spans[:, 1] > spans[:, 0]])
        busy = runs(np.clip(np.stack([self.start, self.end], axis=1), self.lo, self.hi))
        return float(np.sum(spans[:, 1] - spans[:, 0] - covered(busy, spans[:, 0], spans[:, 1])))

    @classmethod
    def from_profile(cls, prof, lo: float, hi: float) -> Optional["ProgramSpans"]:
        """From a ``torch.profiler`` profile that holds the window's range;
        None where it holds no ``vad.*`` range (or its records carry no
        correlation ids)."""
        launch_at: Dict[int, int] = {}  # runtime and driver calls by correlation id
        op_at: Dict[int, int] = {}  # operators by their own correlation id
        device, ranges, names, base = [], {}, set(), None
        for e in prof.profiler.kineto_results.events():
            if not hasattr(e, "correlation_id"):
                return None
            if str(e.device_type()) != "DeviceType.CPU":
                device.append(e)
                continue
            role = _role(e)
            if role == "annotation":
                name = e.name()
                names.add(name)
                if name.startswith(PREFIX):
                    ranges.setdefault(name, []).append((e.start_ns(), _end_ns(e)))
                elif name == WINDOW:
                    base = e.start_ns()
            elif role == "launch":
                launch_at[e.correlation_id()] = e.start_ns()
            elif role == "op":
                op_at[e.correlation_id()] = e.start_ns()
        if not ranges or base is None:
            return None
        # kernels as ``Trace`` tells them from copies, sets and the device's
        # copies of the annotations
        kernels = [e for e in device if _kind(e, names) == "kernel"]
        launches = [launch_at.get(e.correlation_id()) or op_at.get(_linked(e)) for e in kernels]

        def sec(ns) -> np.ndarray:
            return (np.asarray(ns, np.int64) - base) * 1e-9

        launch = np.full(len(kernels), np.nan)
        found = [i for i, t in enumerate(launches) if t is not None]
        launch[found] = sec([launches[i] for i in found])
        return cls({name: sec(iv) for name, iv in ranges.items()}, launch,
                   sec([e.start_ns() for e in kernels]), sec([_end_ns(e) for e in kernels]),
                   lo, hi)


def _linked(event) -> Optional[int]:
    """The correlation id of the operator that launched a kernel (0: none)."""
    linked = event.linked_correlation_id() if hasattr(event, "linked_correlation_id") else 0
    return linked or None


def _role(event) -> Optional[str]:
    """What a host record is here: ``annotation`` (a ``record_function``
    range), ``launch`` (a CUDA runtime or driver call) or ``op`` (an
    operator); records without an activity type (torch 2.11) are told
    apart by the annotation flag and the API's names."""
    if hasattr(event, "activity_type"):
        return ROLES.get(event.activity_type())
    if event.is_user_annotation():
        return "annotation"
    return "launch" if LAUNCH_NAME.match(event.name()) else "op"


def program_spans(trace) -> Optional[ProgramSpans]:
    """The program's spans of a ``Trace`` (read once, kept on it); None
    where the run was not traced or the program has no spans."""
    if trace is None or getattr(trace, "_prof", None) is None:
        return None
    if not hasattr(trace, "program_spans"):
        trace.program_spans = ProgramSpans.from_profile(trace._prof, trace.lo, trace.hi)
    return trace.program_spans


def idle_percent(run, name: str) -> Optional[float]:
    """The share of the window, in %, in which no kernel ran while the host
    was inside the spans ``name``; None where there are none."""
    spans = program_spans(run.trace)
    if spans is None or name not in spans.ranges or spans.window_s <= 0:
        return None
    return 100.0 * spans.idle_s(name) / spans.window_s


def device_ms(run, name: str, outer: str) -> Optional[float]:
    """Device ms a call (a span ``outer`` wholly inside the window) of the
    kernels launched inside the spans ``name``; None where no kernel was."""
    spans = program_spans(run.trace)
    calls = spans.count(outer) if spans is not None else 0
    if not calls:
        return None
    seconds, kernels = spans.launched(name, outer)
    return seconds / calls * 1e3 if kernels else None
