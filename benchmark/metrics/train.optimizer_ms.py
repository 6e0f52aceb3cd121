"""Device ms a train step of the kernels launched inside the program's
``vad.train.optimizer`` span: Adam's ``optimizer.step()``."""

from benchmark.program_spans import device_ms


def read(run):
    return device_ms(run, "vad.train.optimizer", "vad.train.step")
