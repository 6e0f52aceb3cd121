"""The scoring step's share of the chip's dense bf16 peak: frames/s of the
traced window times the model's analytic forward FLOPs a frame
(``counts.model_flops_per_frame``)."""

from benchmark import counts


def read(run):
    rate = run.e2e.get("frames_per_s")
    if not rate:
        return None
    return 100.0 * rate * counts.model_flops_per_frame(run.cfg["image_size"]) / counts.PEAK_FLOPS
