"""Kernels launched a chunk inside the program's ``vad.scorer.step`` span
(by the launch's CUDA runtime record), over the ``vad.scorer.chunk``
spans wholly inside the window."""

from benchmark.program_spans import program_spans

CHUNK, STEP = "vad.scorer.chunk", "vad.scorer.step"


def read(run):
    spans = program_spans(run.trace)
    chunks = spans.count(CHUNK) if spans is not None else 0
    if not chunks:
        return None
    _, kernels = spans.launched(STEP, CHUNK)
    return kernels / chunks if kernels else None
