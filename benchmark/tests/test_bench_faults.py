"""A run with the timed path broken underneath comes out not correct:
the harness's look for a chip is skipped and the rest of a run is driven
on the CPU at a small size, against each cell's own limits.  Each cell's
runner declares the faults its ``plant`` takes (``cases.py``): a step that
leaves its state unchanged; half of the batch left out (its rows answered
from the other half, or the mean taken over the rest); an answer altered
where it is produced; in training, each of those also from the window on,
after the steps checked in set-up.  One chip: no exchange to leave out.
"""

import pytest

from benchmark.manifest import Manifest
from benchmark.tests import cases

M = Manifest()


@pytest.mark.parametrize("cell,fault", cases.fault_cases(M))
def test_a_planted_fault_is_not_correct(cell, fault):
    result, verdict = cases.small_run(M, cell, fault=fault)
    assert result["correct"] is False, verdict.lines()


@pytest.mark.parametrize("cell", cases.sound_cases(M))
def test_a_sound_float32_run_is_correct(cell):
    result, verdict = cases.small_run(M, cell)
    assert result["correct"] is True, verdict.lines()
