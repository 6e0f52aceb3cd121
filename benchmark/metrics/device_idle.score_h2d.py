"""The share of the scoring window in which no kernel ran while the host
was inside the program's ``vad.scorer.h2d`` span: ``score_chunk``'s
synchronous copy of the frames and the mask from pageable memory.  What
staging the copy can win."""

from benchmark.program_spans import idle_percent


def read(run):
    return idle_percent(run, "vad.scorer.h2d")
