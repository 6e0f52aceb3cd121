"""Kernel 4, the fused uint8 input block (``ops/encoder_fused.py`` ->
``csrc/first_block.cu``), against its bytes bound: every chunk's bound
over the device time of ``first_block_kernel``."""

from benchmark import counts

KERNELS = ("first_block_kernel",)
ELEM = {"bfloat16": 2, "float32": 4}


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.device_s(KERNELS)
    if not launches:
        return None
    cfg, tr = run.cfg, run.traffic
    size = cfg["image_size"]
    one = counts.bound_s(*counts.first_block(tr["slots"] * tr["chunk"], size, size,
                                             ELEM[tr["dtype"]]))
    return 100.0 * one * run.counts["chunks"] / seconds
