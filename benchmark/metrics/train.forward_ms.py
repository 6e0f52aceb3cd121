"""Device ms a train step of the kernels launched inside the program's
``vad.train.forward`` span: normalisation, the forward in train mode,
the per-sample loss and its masked sum."""

from benchmark.program_spans import device_ms


def read(run):
    return device_ms(run, "vad.train.forward", "vad.train.step")
