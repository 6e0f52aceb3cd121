"""The share, in %, of the chunks (``vad.scorer.chunk`` spans wholly inside
the window) that hold a ``vad.scorer.stage`` span: those whose frames went
in through the scorer's staged copy.  The staging's engagement counter;
left out where the program has no such span (before the staging)."""

import numpy as np

from benchmark.program_spans import program_spans

CHUNK, STAGE = "vad.scorer.chunk", "vad.scorer.stage"


def read(run):
    spans = program_spans(run.trace)
    if spans is None or STAGE not in spans.ranges:
        return None
    chunks = spans.within(CHUNK)
    if not len(chunks):
        return None
    starts = np.sort(chunks[:, 0])
    stages = spans.within(STAGE, CHUNK)
    held = np.unique(np.searchsorted(starts, stages[:, 0], side="right") - 1)
    return 100.0 * len(held) / len(chunks)
