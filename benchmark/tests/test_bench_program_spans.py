"""The program's spans in a traced window (``benchmark/program_spans.py``):
kernels attributed by launch, idle inside a span, the readers that use
them, and the clock the spans share with the benchmark's own."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import manifest as mf
from benchmark.program_spans import covered, program_spans, runs
from benchmark.tracing import WINDOW, Tracer

BASE = 10**18  # ns: where the window opens
MS = 10**6


class Record:
    """A kineto record as ``ProgramSpans.from_profile`` reads it (times in ms
    from the window's start), as the profiler of torch 2.11 gives it: no
    activity type."""

    def __init__(self, kind, name, start, end, correlation=0, thread=1, linked=0):
        self._kind, self._name, self._corr, self.thread = kind, name, correlation, thread
        self._start, self._end = BASE + int(start * MS), BASE + int(end * MS)
        self._linked = linked

    def device_type(self):
        return "DeviceType.CUDA" if self._kind == "kernel" else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._kind == "user_annotation"

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked


class Event(Record):
    """The same with its activity type, as later profilers give it."""

    def activity_type(self):
        return self._kind


def span(name, start, end):
    return Event("user_annotation", name, start, end)


def kernel(correlation, launch, start, end, thread=1):
    """A kernel and the runtime call that launched it (on ``thread``)."""
    return [Event("cuda_runtime", "cudaLaunchKernel", launch, launch + 0.01, correlation, thread),
            Event("kernel", f"k{correlation}", start, end, correlation)]


def untyped(event):
    record = Record.__new__(Record)
    record.__dict__.update(vars(event))
    return record


def trace_of(events, window_ms=100.0, typed=True):
    if not typed:
        events = [untyped(e) for e in events]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))
    return SimpleNamespace(_prof=prof, lo=0.0, hi=window_ms * 1e-3)


# Two chunks wholly in the window and one cut by its end; kernel 1 is
# launched from another thread inside the first encoder span and runs after
# it closed; kernel 3 is launched outside every span; kernel 6 has no
# launch record; kernel 5 belongs to the chunk that the window cuts.
SCORING = [
    span(WINDOW, 0, 100),
    span("vad.scorer.chunk", 10, 40), span("vad.scorer.h2d", 10, 20),
    span("vad.scorer.step", 20, 35), span("vad.model.encoder", 21, 25),
    span("vad.model.decoder", 26, 30),
    span("vad.scorer.chunk", 50, 80), span("vad.scorer.h2d", 50, 60),
    span("vad.scorer.step", 60, 75), span("vad.model.encoder", 61, 65),
    span("vad.model.decoder", 66, 70),
    span("vad.scorer.chunk", 95, 105), span("vad.scorer.step", 97, 103),
    *kernel(1, 22, 30, 33, thread=2), *kernel(2, 27, 33, 36), *kernel(3, 45, 45, 47),
    *kernel(4, 62, 62, 70), *kernel(5, 98, 98, 99),
    Event("kernel", "k6", 12, 14, correlation=6),
]
# One step: kernel 12 comes from autograd's thread and runs after the
# backward span closed; kernel 15 has no launch record, but the operator
# that launched it (correlation 520, on autograd's thread) ran inside the
# backward span.
TRAINING = [
    span(WINDOW, 0, 100), span("vad.train.step", 0, 50), span("vad.train.forward", 1, 10),
    span("vad.train.backward", 11, 30), span("vad.train.optimizer", 31, 40),
    *kernel(11, 2, 2, 6), *kernel(12, 12, 28, 32, thread=3), *kernel(13, 35, 36, 37),
    *kernel(14, 45, 45, 46),
    Event("cpu_op", "MmBackward0", 13, 14, correlation=520, thread=3),
    Event("kernel", "k15", 29, 30, correlation=15, linked=520),
]


def test_runs_and_coverage():
    iv = np.array([[5.0, 6.0], [0.0, 2.0], [1.0, 3.0], [5.5, 5.7]])
    assert runs(iv).tolist() == [[0.0, 3.0], [5.0, 6.0]]
    assert covered(runs(iv), np.array([0.0, 2.5, 7.0]), np.array([10.0, 5.5, 8.0])).tolist() == \
        pytest.approx([4.0, 1.0, 0.0])


def test_a_kernel_counts_where_it_was_launched():
    """Kernel 1 runs after the encoder span closed and was launched from
    another thread: it counts in the encoder all the same."""
    spans = program_spans(trace_of(SCORING))
    assert spans.launched("vad.model.encoder") == (pytest.approx(0.011), 2)  # kernels 1 and 4
    assert spans.launched("vad.model.decoder") == (pytest.approx(0.003), 1)


def test_a_kernel_launched_outside_every_span_counts_in_none():
    spans = program_spans(trace_of(SCORING))
    assert spans.launched("vad.scorer.step", "vad.scorer.chunk")[1] == 3  # 1, 2 and 4
    assert spans.launched("vad.scorer.step")[1] == 3  # the cut chunk's step is not wholly inside
    assert spans.launched("vad.scorer.h2d")[1] == 0  # kernel 6 has no launch record


def test_a_kernel_without_a_launch_record_counts_where_its_operator_ran():
    spans = program_spans(trace_of(TRAINING))
    assert spans.launched("vad.train.backward") == (pytest.approx(0.005), 2)  # kernels 12, 15


def test_idle_inside_a_span_is_what_no_kernel_covers():
    """h2d: [10, 20] with kernel 6 over [12, 14], and [50, 60]; the steps:
    [20, 35] with kernels over [30, 35], [60, 75] with [62, 70], and [97,
    100] of the cut one, with [98, 99]."""
    spans = program_spans(trace_of(SCORING))
    assert spans.idle_s("vad.scorer.h2d") == pytest.approx(0.018)
    assert spans.idle_s("vad.scorer.step") == pytest.approx(0.019)


def test_calls_are_the_outer_spans_wholly_inside_the_window():
    spans = program_spans(trace_of(SCORING))
    assert spans.count("vad.scorer.chunk") == 2
    assert len(spans.within("vad.scorer.step", "vad.scorer.chunk")) == 2


READINGS = {"device_idle.score_h2d": (SCORING, 18.0), "device_idle.score_issue": (SCORING, 19.0),
            "scorer.issue_ms": (SCORING, 15.0), "scorer.launches": (SCORING, 1.5),
            "score.encoder_ms": (SCORING, 5.5), "score.decoder_ms": (SCORING, 1.5),
            "train.forward_ms": (TRAINING, 4.0), "train.backward_ms": (TRAINING, 5.0),
            "train.optimizer_ms": (TRAINING, 1.0)}


@pytest.mark.parametrize("typed", [True, False], ids=["activity_types", "torch_2_11"])
@pytest.mark.parametrize("metric", sorted(READINGS))
def test_each_reader(metric, typed):
    events, want = READINGS[metric]
    run = SimpleNamespace(trace=trace_of(events, typed=typed), counts={"chunks": 99, "steps": 99})
    assert mf.metric_reader(metric).read(run) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(READINGS))
def test_a_program_without_spans_reads_nothing(metric):
    """The parent of the spans: the window and its kernels, no ``vad.*``
    range; each reader returns nothing (the metric is left out)."""
    events = [e for e in READINGS[metric][0] if not e.name().startswith("vad.")]
    assert program_spans(trace_of(events)) is None
    run = SimpleNamespace(trace=trace_of(events), counts={"chunks": 2, "steps": 1})
    assert mf.metric_reader(metric).read(run) is None


def test_program_spans_share_the_benchmark_clock():
    """A program span inside a benchmark span: after ``Trace``'s alignment
    of the benchmark's host clock, the program's range lies inside it.

    ``Tracer.window_open`` reads the host clock after entering the window's
    range, so a process's first ``record_function`` (≈ 1.4 ms on the CPU)
    would shift the alignment by its cost; the range here is entered once
    before, as a process that already recorded one has it."""
    import torch

    from vad_tpu_torch.utils import profiling

    with torch.profiler.record_function("first"):
        pass
    tracer = Tracer(True)
    tracer.start()
    tracer.window_open()
    time.sleep(0.002)
    with tracer.span("bench"):
        with profiling.span("vad.clock"):
            time.sleep(0.005)
    tracer.window_close()
    tracer.stop()
    (bench,) = [s for s in tracer.trace.spans if s[0] == "bench"]
    (program,) = program_spans(tracer.trace).within("vad.clock")
    early, late = bench[1] - program[0], program[1] - bench[2]
    print(f"program span against the benchmark's: starts {-early * 1e6:.1f} us after, "
          f"ends {-late * 1e6:.1f} us before")
    assert early < 5e-4 and late < 5e-4
