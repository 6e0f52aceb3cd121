"""The share of the scoring window in which no kernel ran while the host
was inside the program's ``vad.scorer.step`` span: issuing the chunk's
eager step, up to the scores' readback.  What graph capture or fewer
launches can win."""

from benchmark.program_spans import idle_percent


def read(run):
    return idle_percent(run, "vad.scorer.step")
