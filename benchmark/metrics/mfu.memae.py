"""MemAE's scoring step's share of the chip's dense bf16 peak: frames/s of
the traced window times the model's analytic forward FLOPs a frame
(``counts_memae.flops_per_frame``: the 3-D convolutions, the transposed
ones and the memory's two products)."""

from benchmark import counts, counts_memae


def read(run):
    rate = run.e2e.get("frames_per_s")
    if not rate:
        return None
    return 100.0 * rate * counts_memae.flops_per_frame(run.cfg) / counts.PEAK_FLOPS
