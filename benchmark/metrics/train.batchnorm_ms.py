"""Device ms a train step of BatchNorm in training mode
(``vad_tpu_torch/models/norms.py``, forward and backward): the kernels
launched while a BatchNorm module's forward or backward ran, which the
traced run brackets with ``batchnorm`` ranges (the runner's
``Tracer.annotate``).  Its batch statistics and normalisation are generic
elementwise and reduction kernels, so no kernel name identifies them."""


def read(run):
    if run.trace is None or not run.counts["steps"]:
        return None
    seconds, ranges = run.trace.device_s_under("batchnorm")
    if not ranges or seconds <= 0:
        return None
    return seconds / run.counts["steps"] * 1e3
