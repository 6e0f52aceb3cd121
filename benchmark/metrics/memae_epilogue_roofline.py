"""Kernel 7 in MemAE's scoring step (``ops/block_epilogue.py`` ->
``csrc/block_epilogue.cu``, the ``leaky`` mode that ends each layer with
BatchNorm3d folded in) against its bytes bound: every chunk's bound over
the device time of the kernels named ``block_epilogue_kernel*``.  A
program that runs MemAE's layers unfolded has no such kernel, and the
metric is left out."""

from benchmark import counts, counts_memae_epilogue

KERNELS = ("block_epilogue_kernel",)
ELEM = {"bfloat16": 2, "float32": 4}


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.device_s(KERNELS)
    if not launches:
        return None
    tr = run.traffic
    one = counts.bound_s(0.0, counts_memae_epilogue.chunk_bytes(run.cfg, tr["slots"],
                                                                ELEM[tr["dtype"]]))
    return 100.0 * one * run.counts["chunks"] / seconds
