"""Device ms a chunk of the kernels launched inside the program's
``vad.model.encoder`` span while scoring MemAE: its four Conv3d layers
with their BatchNorm and LeakyReLU."""

from benchmark.program_spans import device_ms


def read(run):
    return device_ms(run, "vad.model.encoder", "vad.scorer.chunk")
