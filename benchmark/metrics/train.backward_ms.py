"""Device ms a train step of the kernels launched inside the program's
``vad.train.backward`` span: ``.backward()``, whose kernels autograd's
thread launches while the caller waits inside the span."""

from benchmark.program_spans import device_ms


def read(run):
    return device_ms(run, "vad.train.backward", "vad.train.step")
