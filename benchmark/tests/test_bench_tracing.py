"""The reduction of a device trace: busy union, idle gaps and their labels."""

import numpy as np
import pytest

from benchmark.tracing import Trace, gaps, labels_at, union_length


def test_union_counts_overlap_once():
    iv = np.array([[0.0, 2.0], [1.0, 3.0], [5.0, 6.0], [5.5, 5.7], [2.5, 4.0]])
    assert union_length(iv) == pytest.approx(5.0)  # [0, 4] and [5, 6]
    assert union_length(np.zeros((0, 2))) == 0.0


def test_gaps_are_what_no_interval_covers():
    iv = np.array([[1.0, 2.0], [1.5, 3.0], [5.0, 6.0]])
    assert gaps(iv, 0.0, 8.0).tolist() == [[0.0, 1.0], [3.0, 5.0], [6.0, 8.0]]
    assert gaps(np.zeros((0, 2)), 0.0, 1.0).tolist() == [[0.0, 1.0]]


def test_labels_take_the_span_open_at_the_time():
    spans = [("b", 2.0, 4.0), ("a", 0.0, 1.0)]
    assert labels_at(spans, np.array([0.5, 1.5, 3.0, 9.0]), "none") == ["a", "none", "b", "none"]


def _trace(rows, spans=(), lo=0.0, hi=10.0):
    trace = Trace.__new__(Trace)
    trace.lo, trace.hi, trace.default_label = lo, hi, "outside"
    trace.names = [r[0] for r in rows]
    trace.kinds = np.array([r[1] for r in rows])
    trace.iv = np.array([(r[2], r[3]) for r in rows]).reshape(-1, 2)
    trace.spans = list(spans)
    return trace


def test_idle_share_leaves_a_lone_copy_idle():
    trace = _trace([("k1", "kernel", 0.0, 4.0), ("Memcpy HtoD", "memcpy", 4.0, 6.0),
                    ("k2", "kernel", 3.0, 5.0)])
    assert trace.busy_s() == pytest.approx(6.0)
    assert trace.busy_s(kinds=("kernel",)) == pytest.approx(5.0)
    assert trace.device_s(("HtoD",), kinds=("memcpy",)) == (pytest.approx(2.0), 1)


def test_breakdown_sums_ops_and_labels_gaps():
    trace = _trace([("k", "kernel", 0.0, 1.0), ("k", "kernel", 2.0, 3.0), ("j", "kernel", 6.0, 9.0)],
                   spans=[("score_chunk", 0.5, 2.5)])
    assert trace.top_ops() == [["j", pytest.approx(3.0)], ["k", pytest.approx(2.0)]]
    assert trace.idle_gaps() == [["outside x2", pytest.approx(4.0)],
                                 ["score_chunk x1", pytest.approx(1.0)]]


def test_a_traced_run_with_no_kernel_fails():
    """On the CPU the profiler records no device work: the run stops
    without a result rather than print silent or zero readings."""
    from benchmark.manifest import Manifest
    from benchmark.tests.cases import small_run

    with pytest.raises(RuntimeError, match="no kernel"):
        small_run(Manifest(), "video256.stream16", trace=True, seconds=0.5)
