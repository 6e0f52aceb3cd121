"""The share of the training window in which no kernel ran on the device
(``Trace.idle_percent``): a copy with no kernel beside it counts as idle."""


def read(run):
    return run.trace.idle_percent() if run.trace is not None else None
