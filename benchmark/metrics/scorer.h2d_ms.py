"""Device time a chunk of host-to-device copies: the uint8 frames that
``MultiStreamScorer.score_chunk`` copies from pageable host memory."""


def read(run):
    if run.trace is None or not run.counts["chunks"]:
        return None
    seconds, count = run.trace.device_s(("HtoD",), kinds=("memcpy",))
    if not count:
        return None
    return seconds / run.counts["chunks"] * 1e3
