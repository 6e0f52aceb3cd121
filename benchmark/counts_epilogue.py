"""Bytes of the epilogue that ends each folded block of the ConvLSTM video
autoencoder's scoring step (``vad_tpu_torch/csrc/block_epilogue.cu``,
kernel 7): the yardstick of ``block_epilogue_roofline``.

A chunk of F frames has seven such calls: encoder blocks 2-4 (the
convolution's output read, the 2x2-pooled result written), decoder layers
1-3 and the 3-channel output layer (read and written at one size).  Each
counts its convolution's output read once, its result written once and its
f32 bias read once: the same bytes whatever implements the block (before
the fold, a bias add, BatchNorm, the pool and the activation moved them
several times over).  At the published widths, 256 x 256, F = 256, bf16:
872.4 MB read and 218.1 MB written in the encoder, 570.4 MB each way in
the decoder, 2.231 GB a chunk.
"""

from __future__ import annotations

from typing import List, Tuple

# the model's widths (vad_tpu_torch/models/video_autoencoder.py, frozen):
# encoder blocks 2-4 write 64, 128 and latent_dim channels; decoder layers
# 1-3 write 128, 64, 32, and the last one in_channels
ENCODER_WIDTHS = (64, 128)
DECODER_WIDTHS = (128, 64, 32)


def calls(cfg: dict) -> List[Tuple[str, int, int]]:
    """The seven calls a chunk: ``(mode, channels, side of the
    convolution's output)``, encoder blocks 2-4 then the decoder's layers."""
    size = cfg["image_size"]
    enc = [("encoder", c, size // 2 ** (i + 1))
           for i, c in enumerate((*ENCODER_WIDTHS, cfg["latent_dim"]))]
    dec = [("decoder", c, size // 2 ** (3 - i)) for i, c in enumerate(DECODER_WIDTHS)]
    return enc + dec + [("last", cfg["in_channels"], size)]


def chunk_bytes(cfg: dict, frames: int, elem: int) -> float:
    """Bytes the seven calls move for ``frames`` frames of ``elem``-byte
    activations."""
    total = 0.0
    for mode, c, side in calls(cfg):
        read = frames * side * side * c * elem
        written = read / 4 if mode == "encoder" else read
        total += read + written + c * 4
    return total
