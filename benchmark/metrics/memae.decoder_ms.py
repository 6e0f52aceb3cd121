"""Device ms a chunk of the kernels launched inside the program's
``vad.model.decoder`` span while scoring MemAE: the read's cast to the
convolutions' type and the four ConvTranspose3d layers with their
BatchNorm and LeakyReLU."""

from benchmark.program_spans import device_ms


def read(run):
    return device_ms(run, "vad.model.decoder", "vad.scorer.chunk")
