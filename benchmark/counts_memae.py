"""Counts of MemAE's forward work (``reference/memae.py``): the yardstick
of ``mfu.memae``.  Operations are 2 x multiply-adds, as in ``counts.py``.

A convolution counts its output positions x in x out x 27 multiply-adds;
a transposed one its input positions x in x out x 27 (every tap of every
input scattered once); the memory its two products, 2 x Q x M x C each
(the logits z M^T and the read w M) for Q queries of C channels over M
items.  At the published widths, 256 x 256, T = 16: 16.08 G multiply-adds
in the encoder, 16.08 G in the decoder, 0.52 G in the memory a clip, so
4.086e9 FLOPs a frame.
"""

from __future__ import annotations

from typing import List, Tuple


def _down(size: int) -> int:
    """An axis after a stride-2, padding-1 3-tap convolution."""
    return (size + 1) // 2


def volumes(cfg: dict) -> List[Tuple[int, int, int]]:
    """(T, H, W) of a clip at the input and after each encoder layer (the
    first keeps T)."""
    t, h, w = cfg["sequence_length"], cfg["image_size"], cfg["image_size"]
    out = [(t, h, w)]
    for i in range(len(cfg["widths"])):
        t, h, w = (t if i == 0 else _down(t)), _down(h), _down(w)
        out.append((t, h, w))
    return out


def memory_read_flops(queries: int, items: int, channels: int) -> float:
    """The memory's two products for ``queries`` queries: 4 x Q x M x C."""
    return 4.0 * queries * items * channels


def flops_per_frame(cfg: dict) -> float:
    """Forward FLOPs a frame: the clip's convolutions, transposed
    convolutions and memory read over its ``sequence_length`` frames."""
    widths = [cfg["in_channels"], *cfg["widths"]]
    vols = volumes(cfg)
    macs = 0.0
    for i in range(len(cfg["widths"])):
        positions = vols[i + 1][0] * vols[i + 1][1] * vols[i + 1][2]
        # the encoder's layer i writes vols[i + 1]; the decoder's mirror reads it
        macs += 2 * positions * widths[i] * widths[i + 1] * 27
    t, h, w = vols[-1]
    flops = 2 * macs + memory_read_flops(t * h * w, cfg["mem_dim"], widths[-1])
    return flops / cfg["sequence_length"]
