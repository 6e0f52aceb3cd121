"""``BENCHMARK.json`` against its rules, and the files it finds by name."""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import manifest as mf
from benchmark.tests import cases
from benchmark.tracing import Trace

M = mf.Manifest()
DATA = M.data
CELLS = cases.cells(M)


def test_names_and_units():
    assert mf.check_names(DATA) == []
    assert mf.NAME.match("video256.stream16") and not mf.NAME.match("a b")
    assert mf.UNIT.match("frames/s") and mf.UNIT.match("%") and not mf.UNIT.match("frames per s")


def test_keys_are_those_of_the_contract():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    for m in DATA["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in DATA["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert len(json.dumps(DATA)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_it_must(cell):
    e2e = {m["name"] for m in M.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = M.per_layer(cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e, f"{m['name']} moves {m['moves']}, which {cell} does not report"


@pytest.mark.parametrize("metric", cases.metrics(M))
def test_each_metric_reads_nothing_from_an_empty_trace(metric):
    """A reader that finds no device time returns nothing (the metric is
    left out of the line), never 0; the device layer's idle share of an
    empty window is all of it.  A share split by the program's spans
    (another layer's) finds no span, and returns nothing."""
    entry = next(m for m in DATA["per_layer"] if m["name"] == metric)
    cell = M.workload(entry["workloads"][0])
    trace = Trace.__new__(Trace)
    trace.lo, trace.hi, trace.names, trace.spans = 0.0, 1.0, [], []
    trace.kinds, trace.iv = np.array([]), np.zeros((0, 2))
    trace.device_s_under = lambda name: (0.0, 0)
    run = SimpleNamespace(trace=trace, cfg=M.config(cell["config"]),
                          traffic=M.traffic(cell["traffic"]), e2e={},
                          counts={"chunks": 10, "steps": 10})
    value = mf.metric_reader(metric, M.folder).read(run)
    assert value == (100.0 if entry["layer"] == "device" else None)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    entry = M.workload(cell)
    cfg = M.config(entry["config"])
    assert cfg["reduced"] == next(
        c["reduced"] for c in DATA["configs"] if c["name"] == entry["config"])
    assert mf.reference(cfg, M.folder).layout(cfg)
    traffic = M.traffic(entry["traffic"])
    mf.runner(traffic["runner"])
    assert M.limits(cell), f"no limits for {cell}"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_declares_its_cpu_test_sizes(cell):
    """The reference's ``TINY`` and the runner's ``SMALL`` shrink keys that
    the cell's files have (a key they lack would change nothing)."""
    d = cases.declared(M, cell)
    entry = M.workload(cell)
    assert set(d.tiny) <= set(M.config(entry["config"]))
    assert set(d.small) <= set(M.traffic(entry["traffic"]))
    assert d.faults


def test_files_lie_under_paths():
    for c in DATA["configs"]:
        assert any(c["file"].startswith(p + "/") for p in DATA["paths"])
    assert all(not w.startswith("/") and ".." not in w for w in DATA["command"])


def test_forbidden_modules_compare_whole_top_level_names():
    assert mf.forbidden_modules(["vad_tpu_torch", "vad_tpu_torch.eval", "jaxtyping",
                                 "flaxen", "numpy"]) == []
    assert mf.forbidden_modules(["vad_tpu.ops", "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "vad_tpu"]
