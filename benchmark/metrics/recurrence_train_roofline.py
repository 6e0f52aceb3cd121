"""Kernels 2 and 3, the ConvLSTM recurrence's training forward
(``csrc/convlstm_serving.cu`` built with ``STORE_CELL``) and backward
(``csrc/convlstm_backward.cu``), against their bound: every layer's
forward and backward bound of every step in the window over the device
time of their kernels, by name (kernel 1 does not run in training)."""

from benchmark import counts

KERNELS = ("recurrence_kernel", "convlstm_step_kernel", "convlstm_tc_step", "gate_all_kernel",
           "gate_tc", "gate_kernel", "loop_kernel", "dh_tc_step", "step_kernel",
           "finish_kernel", "finish_tc", "dw_kernel_res", "dw_reduce_kernel", "dw_kernel",
           "dw_tc")
ELEM = {"f32": 4, "bf16": 2}


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.device_s(KERNELS)
    if not launches:
        return None
    cfg, tr = run.cfg, run.traffic
    lat, c, e = cfg["image_size"] // 16, cfg["lstm_hidden_dim"], ELEM[tr["precision"]]
    shape = (tr["batch"], cfg["sequence_length"], lat, lat, c, e)
    one = (counts.bound_s(*counts.recurrence_forward(*shape, cell=True))
           + counts.bound_s(*counts.recurrence_backward(*shape)))
    return 100.0 * one * cfg["lstm_layers"] * run.counts["steps"] / seconds
