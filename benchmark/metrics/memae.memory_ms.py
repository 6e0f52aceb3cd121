"""Device ms a chunk of the kernels launched inside the program's
``vad.model.memory`` span while scoring MemAE: the float32 addressing
(logits, softmax, hard shrinkage, L1 normalisation) and the read, what a
fused addressing kernel would take."""

from benchmark.program_spans import device_ms


def read(run):
    return device_ms(run, "vad.model.memory", "vad.scorer.chunk")
