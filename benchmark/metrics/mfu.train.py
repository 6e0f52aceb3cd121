"""The train step's share of the chip's dense bf16 peak: trained frames/s
of the traced window times three forward passes' FLOPs a frame (forward
and backward)."""

from benchmark import counts


def read(run):
    rate = run.e2e.get("train_frames_per_s")
    if not rate:
        return None
    flops = 3 * counts.model_flops_per_frame(run.cfg["image_size"])
    return 100.0 * rate * flops / counts.PEAK_FLOPS
