"""Each cell's control, the reference one precision lower than the cell
states put in the program's place, comes out not correct: here at the
small size its files declare (``cases.py``), on the card at the cell's own
size (``card``; the readings of that run set the upper ends of the limits,
``PERF.md``)."""

import pytest

from benchmark.manifest import Manifest
from benchmark.run import execute
from benchmark.tests import cases

M = Manifest()


@pytest.mark.parametrize("cell", cases.cells(M))
def test_control_at_a_small_size_is_not_correct(cell):
    result, verdict = cases.small_run(M, cell, side="control")
    assert result["correct"] is False, verdict.lines()


@pytest.mark.card
@pytest.mark.parametrize("cell", cases.cells(M))
def test_control_at_the_cells_size_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    entry = M.workload(cell)
    for seed in (2**31 + 21, 2**31 + 22, 2**31 + 23):
        result, verdict = execute(M, entry, seed, 5.0, False, "cuda", side="control")
        assert result["correct"] is False, verdict.lines()
