"""Kernel 1, the ConvLSTM recurrence of serving (``ops/convlstm.py`` ->
``csrc/convlstm_serving.cu``), against its bound: the bound of every
layer-call in the window over the device time of its kernels, by name (in
a scoring cell no other recurrence kernel runs)."""

from benchmark import counts

KERNELS = ("recurrence_kernel", "convlstm_step_kernel", "convlstm_tc_step")
ELEM = {"bfloat16": 2, "float32": 4}


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.device_s(KERNELS)
    if not launches:
        return None
    cfg, tr = run.cfg, run.traffic
    lat = cfg["image_size"] // 16
    one = counts.bound_s(*counts.recurrence_forward(
        tr["slots"], tr["chunk"], lat, lat, cfg["lstm_hidden_dim"], ELEM[tr["dtype"]]))
    return 100.0 * one * cfg["lstm_layers"] * run.counts["chunks"] / seconds
