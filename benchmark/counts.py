"""Frozen counts of work and the chip's peaks: the yardstick of every
roofline and ``mfu`` metric.

Operations are 2 x multiply-adds; bytes count each input read once and
each output written once, whatever a kernel reads again.  A bound is
max(operations / dense bf16 peak, bytes / memory peak) whatever the
precision the work runs in: no float32-accurate design beats the bf16
dense rate, so no design can read over 100% of it.  The counts are
copies, frozen here, of the port's own:

- ``model_flops_per_frame``: ``vad_tpu_torch/bench.py:123`` (the
  ``pool`` stem);
- ``recurrence_forward``: ``chip_smoke.py:457-460`` (kernel 1) and
  ``:1197-1199`` (kernel 2, ``cell``: the cell sequence stored too);
- ``recurrence_backward``: ``chip_smoke.py:1269-1273`` (kernel 3);
- ``first_block``: ``vad_tpu_torch/tools/ablate_block1.py:57`` (kernel 4,
  mode ``full``).
"""

from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense: bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip can take for this work."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def model_flops_per_frame(image_size: int) -> float:
    """Forward FLOPs a frame of the video autoencoder at its published
    widths (convolutions, ConvTransposes, ConvLSTM gate convolutions)."""
    f = 0.0
    res = image_size * image_size
    for cin, cout in ((3, 32), (32, 64), (64, 128), (128, 128)):
        f += res * cin * 9 * cout * 2
        res //= 4
    lat_hw = image_size * image_size // 256
    f += 2 * 2 * (lat_hw * 128 * 9 * 512 * 2)
    res = lat_hw
    for cin, cout in ((128, 128), (128, 64), (64, 32), (32, 3)):
        f += res * cin * 4 * cout * 2
        res *= 4
    return f


def recurrence_forward(b: int, t: int, h: int, w: int, c: int, elem: int,
                       cell: bool = False):
    """(FLOP, bytes) of one ConvLSTM layer's recurrence (kernels 1 and 2):
    gates_x and W_h in, h_seq (and c_seq) out, h0, c0, h_T, c_T in f32."""
    hw = h * w
    flops = 2 * b * t * hw * 9 * c * 4 * c
    nbytes = (b * t * hw * 4 * c * elem + (2 if cell else 1) * b * t * hw * c * elem
              + 4 * b * hw * c * 4 + 9 * c * 4 * c * elem)
    return flops, nbytes


def recurrence_backward(b: int, t: int, h: int, w: int, c: int, elem: int):
    """(FLOP, bytes) of one layer's backward recurrence (kernel 3): the gate
    recompute, the dh product and dWh; gates_x, h_seq, c_seq, dh_seq, W_h,
    h0, c0, dh_T, dc_T in, dgates_x, dW_h, dh0, dc0 out."""
    seq = b * t * h * w * c
    state, w_bytes = b * h * w * c * 4, 9 * c * 4 * c * elem
    flops = 3 * 2 * seq * 9 * c * 4
    nbytes = 2 * seq * 4 * elem + 3 * seq * elem + 2 * w_bytes + 6 * state
    return flops, nbytes


def first_block(frames: int, height: int, width: int, out_elem: int):
    """(FLOP, bytes) of the fused uint8 input block (kernel 4): the frames
    and the folded weights read once, the pooled output written once."""
    flops = 2 * frames * height * width * 32 * 27
    nbytes = (frames * height * width * 3
              + frames * (height // 2) * (width // 2) * 32 * out_elem + (864 + 32) * 4)
    return flops, nbytes
