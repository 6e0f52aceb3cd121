"""Kernel 7, the epilogue that ends each folded block of the scoring step
(``ops/block_epilogue.py`` -> ``csrc/block_epilogue.cu``), against its
bytes bound: every chunk's bound over the device time of the kernels named
``block_epilogue_kernel*``.  A program that runs the blocks unfolded has no
such kernel, and the metric is left out."""

from benchmark import counts, counts_epilogue

KERNELS = ("block_epilogue_kernel",)
ELEM = {"bfloat16": 2, "float32": 4}


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.device_s(KERNELS)
    if not launches:
        return None
    tr = run.traffic
    one = counts.bound_s(0.0, counts_epilogue.chunk_bytes(run.cfg, tr["slots"] * tr["chunk"],
                                                          ELEM[tr["dtype"]]))
    return 100.0 * one * run.counts["chunks"] / seconds
