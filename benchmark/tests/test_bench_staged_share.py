"""``scorer.staged_share`` on synthetic profiles: the share of the chunks
wholly inside the window that hold a ``vad.scorer.stage`` span."""

from types import SimpleNamespace

import pytest

from benchmark import manifest as mf
from benchmark.tests.test_bench_program_spans import kernel, span, trace_of
from benchmark.tracing import WINDOW

METRIC = "scorer.staged_share"


def chunk(start, staged):
    """One ``score_chunk`` of 30 ms: the copy, staged or not, then the step
    with one kernel."""
    spans = [span("vad.scorer.chunk", start, start + 30), span("vad.scorer.h2d", start, start + 10),
             span("vad.scorer.step", start + 10, start + 25),
             *kernel(int(start), start + 11, start + 12, start + 20)]
    if staged:
        spans.append(span("vad.scorer.stage", start + 1, start + 9))
    return spans


def read(events, typed=True):
    run = SimpleNamespace(trace=trace_of(events, window_ms=200.0, typed=typed),
                          counts={"chunks": 99})
    return mf.metric_reader(METRIC).read(run)


# four chunks wholly inside the window and one that its end cuts (staged,
# and not counted)
@pytest.mark.parametrize("typed", [True, False], ids=["activity_types", "torch_2_11"])
@pytest.mark.parametrize("staged, want", [((1, 1, 1, 1), 100.0), ((1, 0, 1, 0), 50.0),
                                          ((0, 0, 0, 1), 25.0)])
def test_share_of_the_chunks_that_hold_a_stage(staged, want, typed):
    events = [span(WINDOW, 0, 200)]
    for i, s in enumerate(staged):
        events += chunk(10 + 40 * i, s)
    events += chunk(185, True)
    assert read(events, typed) == pytest.approx(want)


@pytest.mark.parametrize("program", ["spans_without_stage", "no_spans"])
def test_a_program_without_the_stage_span_reads_nothing(program):
    """The parent of the staging (its chunks have spans, none a stage) and
    a program with no spans at all: the metric is left out."""
    events = [span(WINDOW, 0, 200)] + chunk(10, False) + chunk(50, False)
    if program == "no_spans":
        events = [e for e in events if not e.name().startswith("vad.")]
    assert read(events) is None
