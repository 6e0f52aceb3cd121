"""A run with the timed path broken underneath comes out not correct:
the harness's look for a chip is skipped and the rest of a run is driven
on the CPU at a small size, against each cell's own limits.  Faults: a
step that leaves its state unchanged; half of the batch left out (its
rows answered from the other half, or the mean taken over the rest); an
answer altered where it is produced; in training, each of those also from
the window on, after the steps checked in set-up.  One chip: no exchange to leave out.
"""

import pytest

from benchmark.manifest import Manifest
from benchmark.run import execute

M = Manifest()
CELLS = M.data["workloads"]
TINY = {"image_size": 32, "latent_dim": 16, "lstm_hidden_dim": 16, "sequence_length": 4}
SMALL = {"stream_scorer": {"slots": 4, "chunk": 4, "pool_chunks": 2, "warm_chunks": 2,
                           "sample_chunks": 3, "dtype": "float32"},
         "train_step": {"batch": 4, "pool_batches": 3}}
FAULTS = {"stream_scorer": ("unchanged", "half_batch", "altered"),
          "train_step": ("unchanged", "half_batch", "window_unchanged", "window_half_batch")}


def small_run(cell, side="program", fault=None, seconds=1.5, seed=2**31 + 11, trace=False):
    entry = next(c for c in CELLS if c["name"] == cell)
    cfg = dict(M.config(entry["config"]), **TINY)
    traffic = M.traffic(entry["traffic"])
    traffic.update(SMALL[traffic["runner"]])
    return execute(M, entry, seed, seconds, trace, "cpu", side=side, fault=fault, cfg=cfg,
                   traffic=traffic)


CASES = [(w["name"], f) for w in CELLS for f in FAULTS[M.traffic(w["traffic"])["runner"]]]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    result, verdict = small_run(cell, fault=fault)
    assert result["correct"] is False, verdict.lines()


@pytest.mark.parametrize("cell", [w["name"] for w in CELLS
                                  if M.traffic(w["traffic"])["runner"] != "train_step"])
def test_a_sound_float32_run_is_correct(cell):
    result, verdict = small_run(cell)
    assert result["correct"] is True, verdict.lines()
