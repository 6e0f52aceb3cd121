"""A configuration joins the benchmark by new files alone: on a copy of
``BENCHMARK.json`` and its data in a temporary root, one more configuration,
traffic mix, limits file, metric and cell, whose reference and runner
declare their own CPU test sizes and faults.  The only existing entry
touched is the end-to-end metric's list of cells."""

import json
import os
import shutil
import sys
import types
from pathlib import Path

import pytest

from benchmark import manifest as mf
from benchmark.tests import cases

CELL, CONFIG, MIX, METRIC = "stub3d.mix", "stub3d_256", "stub3d_mix", "stub3d.step_ms"
TINY = {"image_size": 32, "base_width": 8}
SMALL = {"clips": 2}
FAULTS = ("unchanged", "altered")
REFERENCE = '''
def layout(cfg):
    return [("conv3d.weight", (cfg["base_width"], 3, 3, 3, 3))]
'''


def _snapshot():
    out = {}
    for top, dirs, files in os.walk(mf.ROOT):
        dirs[:] = [d for d in dirs if d not in (".git", "__pycache__")]
        for f in files:
            st = os.stat(os.path.join(top, f))
            out[os.path.join(top, f)] = (st.st_mtime_ns, st.st_size)
    return out


def _write(path: Path, text: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def _root(tmp: Path, reference_tiny=True, config_names_reference=True) -> mf.Manifest:
    """A root with today's benchmark data plus the stub cell's new files."""
    folder = tmp / mf.HERE.name
    for part in ("configs", "reference", "traffic", "limits", "metrics"):
        shutil.copytree(mf.HERE / part, folder / part)
    data = json.loads((mf.ROOT / "BENCHMARK.json").read_text())
    data["configs"].append({"name": CONFIG, "source": "https://example.org/stub3d",
                            "file": f"{mf.HERE.name}/configs/{CONFIG}.json", "reduced": [],
                            "why": "a 3D-convolutional stub"})
    data["workloads"].append({"name": CELL, "config": CONFIG, "traffic": MIX, "chips": 1,
                              "why": "the stub's scoring"})
    next(m for m in data["end_to_end"] if m["name"] == "frames_per_s")["workloads"].append(CELL)
    data["per_layer"].append({"name": METRIC, "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "model",
                              "moves": "frames_per_s", "workloads": [CELL]})
    _write(tmp / "BENCHMARK.json", json.dumps(data))
    cfg = {"image_size": 256, "base_width": 96, "reduced": []}
    if config_names_reference:
        cfg["reference"] = "reference/stub3d.py"
    _write(folder / "configs" / f"{CONFIG}.json", json.dumps(cfg))
    _write(folder / "reference" / "stub3d.py",
           (f"TINY = {TINY!r}\n" if reference_tiny else "") + REFERENCE)
    _write(folder / "traffic" / f"{MIX}.json",
           json.dumps({"runner": "stub3d_scorer", "clips": 16}))
    _write(folder / "limits" / f"{CELL}.json",
           json.dumps({"numbers": {"score_gap": {"limit": 0.01, "lower": 0.001, "upper": 0.1}}}))
    _write(folder / "metrics" / f"{METRIC}.py", "def read(run):\n    return None\n")
    return mf.Manifest(tmp)


def _runner(monkeypatch, leave_out=None):
    runner = types.ModuleType("benchmark.runners.stub3d_scorer")
    declared = {"SMALL": SMALL, "FAULTS": FAULTS, "SOUND_SMALL_RUN_CORRECT": True}
    for name, value in declared.items():
        if name != leave_out:
            setattr(runner, name, value)
    monkeypatch.setitem(sys.modules, runner.__name__, runner)


def test_a_new_cell_gets_its_cases_from_its_own_declarations(tmp_path, monkeypatch):
    before = _snapshot()
    _runner(monkeypatch)
    m = _root(tmp_path)
    here = mf.Manifest()

    faults = cases.fault_cases(m)
    assert [c for c in faults if c[0] == CELL] == [(CELL, f) for f in FAULTS]
    assert [c for c in faults if c[0] != CELL] == cases.fault_cases(here)
    assert cases.sound_cases(m) == cases.sound_cases(here) + [CELL]
    assert cases.cells(m) == cases.cells(here) + [CELL]  # the control cases
    cfg, traffic = cases.small_inputs(m, CELL)
    assert cfg == {"image_size": 32, "base_width": 8, "reduced": [],
                   "reference": "reference/stub3d.py"}
    assert traffic == {"runner": "stub3d_scorer", "clips": 2}
    assert cases.declared(m, CELL) == cases.Declared(TINY, SMALL, FAULTS, True)

    # the manifest's cases: names, files found by name under the root, the metrics reported
    assert mf.check_names(m.data) == []
    assert cases.metrics(m) == cases.metrics(here) + [METRIC]
    assert {e["name"] for e in m.end_to_end(CELL)} == {"frames_per_s", "setup_s"}
    assert [e["name"] for e in m.per_layer(CELL)] == [METRIC]
    assert m.limits(CELL) == {"score_gap": 0.01}
    assert mf.metric_reader(METRIC, m.folder).read(None) is None
    assert mf.reference(cfg, m.folder).layout(cfg) == [("conv3d.weight", (8, 3, 3, 3, 3))]
    for cell in cases.cells(here):
        assert m.per_layer(cell) == here.per_layer(cell)
        assert [e["name"] for e in m.end_to_end(cell)] == [e["name"] for e in here.end_to_end(cell)]

    assert _snapshot() == before, "a file of the repository was written"


@pytest.mark.parametrize("missing", ["TINY", "SMALL", "FAULTS", "SOUND_SMALL_RUN_CORRECT",
                                     "reference"])
def test_a_missing_declaration_fails_by_its_name(tmp_path, monkeypatch, missing):
    before = _snapshot()
    _runner(monkeypatch, leave_out=missing)
    m = _root(tmp_path, reference_tiny=missing != "TINY",
              config_names_reference=missing != "reference")
    here = mf.Manifest()

    # collection still builds every case; the stub cell's one case fails by name
    faults = cases.fault_cases(m)
    assert faults[:-1] == cases.fault_cases(here)
    assert faults[-1].id == f"{CELL}-undeclared"
    assert cases.sound_cases(m)[-1].id == f"{CELL}-undeclared"
    with pytest.raises(cases.Undeclared, match=missing):
        cases.declared(m, CELL)
    with pytest.raises(cases.Undeclared, match=missing):
        cases.small_run(m, CELL, side="control")
    assert _snapshot() == before, "a file of the repository was written"
