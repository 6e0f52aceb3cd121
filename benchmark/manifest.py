"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads``) names a configuration (``configs/<name>.json``, the
sizes as run, which names its plain ``reference``) and a traffic mix
(``traffic/<name>.json``, the parameters that its ``runner``,
``runners/<runner>.py``, reads).  Each per-layer metric is read by
``metrics/<name>.py``; each cell's limits on the numbers that decide
``correct`` are in ``limits/<cell>.json``.  A later cell, configuration or
metric is added by adding files and entries.

What a configuration's files declare for the benchmark's CPU tests
(``benchmark/tests/cases.py``): its reference a ``layout(cfg)`` of the
weights (``weights.py`` draws them) and ``TINY``, the sizes a CPU run of
the model uses; its runner ``SMALL``, the traffic a CPU run uses,
``FAULTS``, the names its ``plant`` takes, and
``SOUND_SMALL_RUN_CORRECT``, whether a sound float32 run at those sizes
is held to the cell's limits.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# top-level module names the timed process may not hold (compared whole:
# the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "vad_tpu")


def forbidden_modules(modules) -> List[str]:
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Manifest:
    def __init__(self, root: Path = ROOT) -> None:
        self.root = root
        self.folder = root / HERE.name  # this folder in the checkout at ``root``
        self.data = _load_json(root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for cell in self.data["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == name)
        return _load_json(self.root / entry["file"])

    def traffic(self, name: str) -> dict:
        return _load_json(self.folder / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> Dict[str, float]:
        path = self.folder / "limits" / f"{cell}.json"
        if not path.exists():
            return {}
        return {k: v["limit"] for k, v in _load_json(path)["numbers"].items()}

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The cell's per-layer metrics: those that list it, and those
        without a list whose end-to-end metric the cell reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in reported else [])]


def runner(name: str) -> ModuleType:
    return importlib.import_module(f"benchmark.runners.{name}")


def metric_reader(name: str, folder: Path = HERE) -> ModuleType:
    """``metrics/<name>.py`` (metric names hold dots, so it loads by path)."""
    return _load_module(folder / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def reference(cfg: dict, folder: Path = HERE) -> ModuleType:
    """The plain reference that the configuration ``cfg`` names
    (``"reference"``, a path in this folder), loaded by path."""
    path = folder / cfg["reference"]
    return _load_module(path, f"benchmark_reference_{path.stem}")


def check_names(data: dict) -> List[str]:
    """What in ``data`` (BENCHMARK.json) breaks the naming rules."""
    bad = []
    named = [*data["configs"], *data["workloads"], *data["end_to_end"], *data["per_layer"]]
    for entry in named:
        if not NAME.match(entry["name"]):
            bad.append(f"name {entry['name']!r}")
    for entry in data["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(entry[key]):
                bad.append(f"{key} {entry[key]!r}")
    for entry in data["configs"]:
        bad += [f"reduced {k!r}" for k in entry["reduced"] if not NAME.match(k)]
    for entry in [*data["end_to_end"], *data["per_layer"]]:
        if not UNIT.match(entry["unit"]):
            bad.append(f"unit {entry['unit']!r}")
        if entry["better"] not in ("lower", "higher"):
            bad.append(f"better {entry['better']!r}")
    return bad
