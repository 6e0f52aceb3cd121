"""Bytes of the pass that ends each of MemAE's layers with inference
BatchNorm3d folded in (``vad_tpu_torch/csrc/block_epilogue.cu``, kernel 7,
its ``leaky`` mode): the yardstick of ``memae_epilogue_roofline``.

A chunk of ``slots`` clips has seven such calls: the encoder's four 3-D
convolutions and the decoder's first three transposed ones (the output
layer has no BatchNorm).  Each counts its convolution's output read once,
its result written once and its f32 bias read once: the same bytes
whatever implements the layer (before the fold, a bias add, BatchNorm3d
and LeakyReLU moved them three times over).  At the published widths,
256 x 256, 16 clips of 16 frames, bf16: 975,175,680 elements each way,
3,900,707,584 B a chunk, 1.164 ms at 3.35 TB/s.
"""

from __future__ import annotations

from typing import List, Tuple

from benchmark import counts_memae


def calls(cfg: dict) -> List[Tuple[int, int, int, int]]:
    """The seven calls of one clip: ``(T, H, W, channels)`` of each folded
    layer's output, the encoder's four then the decoder's first three (the
    mirror of the encoder's first three)."""
    vols = counts_memae.volumes(cfg)[1:]
    enc = [(*v, c) for v, c in zip(vols, cfg["widths"])]
    return enc + enc[-2::-1]


def chunk_bytes(cfg: dict, clips: int, elem: int) -> float:
    """Bytes the seven calls move for ``clips`` clips of ``elem``-byte
    activations."""
    total = 0.0
    for t, h, w, c in calls(cfg):
        total += 2 * clips * t * h * w * c * elem + c * 4
    return total
