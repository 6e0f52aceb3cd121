"""The CPU test cases of every cell in ``BENCHMARK.json``, built from what
the cell's own files declare (``benchmark/manifest.py``): the reference's
``TINY`` sizes, the runner's ``SMALL`` traffic, ``FAULTS`` and
``SOUND_SMALL_RUN_CORRECT``.  A cell whose files lack a declaration gets one
case, which fails with a message that names what is missing."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import pytest

from benchmark import manifest as mf
from benchmark.run import execute

SEED = 2**31 + 11
RUNNER_DECLARES = ("SMALL", "FAULTS", "SOUND_SMALL_RUN_CORRECT")


class Undeclared(Exception):
    """A cell's reference or runner lacks a declaration the tests need."""


@dataclass(frozen=True)
class Declared:
    tiny: dict
    small: dict
    faults: tuple
    sound_small_run_correct: bool


def declared(manifest: mf.Manifest, cell: str) -> Declared:
    entry = manifest.workload(cell)
    cfg = manifest.config(entry["config"])
    traffic = manifest.traffic(entry["traffic"])
    if "reference" not in cfg:
        raise Undeclared(f"{cell}: configuration {entry['config']!r} names no \"reference\"")
    ref = mf.reference(cfg, manifest.folder)
    run = mf.runner(traffic["runner"])
    missing = [f"reference {cfg['reference']} declares no TINY"] if not hasattr(ref, "TINY") else []
    missing += [f"runner {traffic['runner']} declares no {name}"
                for name in RUNNER_DECLARES if not hasattr(run, name)]
    if missing:
        raise Undeclared(f"{cell}: " + "; ".join(missing))
    return Declared(ref.TINY, run.SMALL, tuple(run.FAULTS), bool(run.SOUND_SMALL_RUN_CORRECT))


def _declared_or_none(manifest, cell):
    try:
        return declared(manifest, cell)
    except Undeclared:
        return None


def cells(manifest: mf.Manifest) -> List[str]:
    return [w["name"] for w in manifest.data["workloads"]]


def metrics(manifest: mf.Manifest) -> List[str]:
    return [m["name"] for m in manifest.data["per_layer"]]


def _undeclared(cell, *rest):
    return pytest.param(cell, *rest, id=f"{cell}-undeclared")


def fault_cases(manifest: mf.Manifest) -> list:
    """(cell, fault) for every fault each cell's runner declares."""
    out = []
    for cell in cells(manifest):
        d = _declared_or_none(manifest, cell)
        out += [(cell, f) for f in d.faults] if d else [_undeclared(cell, None)]
    return out


def sound_cases(manifest: mf.Manifest) -> list:
    """The cells whose runners hold a sound small run to the limits."""
    out = []
    for cell in cells(manifest):
        d = _declared_or_none(manifest, cell)
        if d is None:
            out.append(_undeclared(cell))
        elif d.sound_small_run_correct:
            out.append(cell)
    return out


def small_inputs(manifest: mf.Manifest, cell: str):
    """The cell's configuration and traffic at the sizes its files declare
    for a CPU run."""
    d = declared(manifest, cell)
    entry = manifest.workload(cell)
    cfg = dict(manifest.config(entry["config"]), **d.tiny)
    traffic = dict(manifest.traffic(entry["traffic"]), **d.small)
    return cfg, traffic


def small_run(manifest: mf.Manifest, cell: str, side="program", fault=None, seconds=1.5,
              seed=SEED, trace=False):
    """One run of ``cell`` on the CPU at its small sizes, against its own
    limits: ``(result, verdict)``."""
    cfg, traffic = small_inputs(manifest, cell)
    return execute(manifest, manifest.workload(cell), seed, seconds, trace, "cpu", side=side,
                   fault=fault, cfg=cfg, traffic=traffic)
