"""Device ms a chunk of the kernels launched inside the program's
``vad.model.encoder`` span while scoring: encoder blocks 2-4 after the
fused input block (kernel 4 and the ConvLSTM lie outside it)."""

from benchmark.program_spans import device_ms


def read(run):
    return device_ms(run, "vad.model.encoder", "vad.scorer.chunk")
