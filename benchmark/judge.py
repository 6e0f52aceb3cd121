"""The numbers that decide ``correct``, and their limits.

Each runner compares what the program produced on its timed path with
the plain reference (``reference/``) and hands back named numbers; each
has a limit in ``limits/<cell>.json``, set from the largest reading of
sound runs and the smallest reading of the cell's control (``PERF.md``
gives both).  A run is correct when every number is finite and within
its limit.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping, Sequence, Tuple

import torch


def rel_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The widest elementwise gap relative to the reference's value."""
    p, r = torch.as_tensor(program).double(), torch.as_tensor(reference).double()
    return float(((p - r).abs() / r.abs().clamp_min(1e-12)).max())


def state_gap(program: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              reference: Sequence[Tuple[torch.Tensor, torch.Tensor]]) -> float:
    """The widest relative L2 gap over every layer's h and c."""
    worst = 0.0
    for pair_p, pair_r in zip(program, reference):
        for p, r in zip(pair_p, pair_r):
            p, r = p.double(), r.to(p.device).double()
            worst = max(worst, float(torch.linalg.vector_norm(p - r)
                                     / torch.linalg.vector_norm(r).clamp_min(1e-30)))
    return worst


def moved_leaves(ref_grads: Mapping[str, torch.Tensor]) -> Iterable[str]:
    """Leaves whose reference gradient is no rounding noise: norm at least
    a thousandth of the median leaf's (a bias ahead of a BatchNorm in
    training mode gets none, and Adam moves it by round-off alone)."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in ref_grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return [k for k, n in norms.items() if n >= 1e-3 * median]


def _leaf_gaps(program, reference, leaves) -> Dict[str, float]:
    ref = {k: float(torch.linalg.vector_norm(reference[k].double())) for k in leaves}
    median = sorted(ref.values())[len(ref) // 2]
    return {k: abs(float(torch.linalg.vector_norm(program[k].double())) - ref[k])
            / max(ref[k], median) for k in leaves}


def norm_gap(program: Mapping[str, torch.Tensor], reference: Mapping[str, torch.Tensor],
             leaves: Iterable[str]) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    return max(_leaf_gaps(program, reference, list(leaves)).values())


def median_leaf_gap(program: Mapping[str, torch.Tensor],
                    reference: Mapping[str, torch.Tensor], leaves: Iterable[str]) -> float:
    """The median over leaves of ``norm_gap``'s per-leaf gaps: steady where
    one leaf's gap is set by rounding (Adam steps each element by the sign
    of a gradient that may lie within its rounding)."""
    gaps = sorted(_leaf_gaps(program, reference, list(leaves)).values())
    return gaps[len(gaps) // 2]


def worst_leaf(program, reference, leaves) -> str:
    gaps = _leaf_gaps(program, reference, list(leaves))
    name = max(gaps, key=gaps.get)
    return f"{name} {gaps[name]!r} ({reference[name].numel()} values)"


class Verdict:
    """Named numbers against their limits."""

    def __init__(self, numbers: Dict[str, float], limits: Dict[str, float]) -> None:
        self.numbers, self.limits = numbers, limits
        self.missing = sorted(set(numbers) - set(limits))

    @property
    def correct(self) -> bool:
        return not self.missing and all(
            math.isfinite(v) and v <= self.limits[k] for k, v in self.numbers.items())

    def checks(self) -> Dict[str, dict]:
        return {k: {"value": v, "limit": self.limits.get(k)} for k, v in self.numbers.items()}

    def lines(self) -> list:
        out = [f"no limit for {k}" for k in self.missing]
        return out + [f"check {k} {v!r} limit {self.limits.get(k)!r}"
                      for k, v in self.numbers.items()]
