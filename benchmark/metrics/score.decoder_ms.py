"""Device ms a chunk of the kernels launched inside the program's
``vad.model.decoder`` span while scoring: the four ConvTranspose blocks,
their BatchNorm and activations."""

from benchmark.program_spans import device_ms


def read(run):
    return device_ms(run, "vad.model.decoder", "vad.scorer.chunk")
