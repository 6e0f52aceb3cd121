"""Host ms a chunk inside the program's ``vad.scorer.step`` span (issuing
the eager step): the pace the host can set once the copy is hidden.
Chunks are the ``vad.scorer.chunk`` spans wholly inside the window."""

from benchmark.program_spans import program_spans

CHUNK, STEP = "vad.scorer.chunk", "vad.scorer.step"


def read(run):
    spans = program_spans(run.trace)
    chunks = spans.count(CHUNK) if spans is not None else 0
    if not chunks or not len(spans.within(STEP, CHUNK)):
        return None
    return spans.host_s(STEP, CHUNK) / chunks * 1e3
