"""Seeded moving scenes: the benchmark's video frames.

A frozen copy of the port's orbit generator (``vad_tpu_torch/data/
synthetic.py``: ``_gradient_bg`` :40, ``_disk_mask`` :47, ``_ring_mask``
:52, ``_video_frame`` :233): a circle with a ring orbiting the centre of
a vertical gradient, and in some chunks a dark intruder moving against
it.  Each stream has its own phase and speed (uniform in [0, 2 pi) and
[0.12, 0.2] rad a frame, as the fixture's training videos).  The masks
are evaluated only inside each disk's bounding box, which gives the
generator's pixels exactly and costs a fraction of a full frame.

Everything is a function of (seed, stream, chunk index), so a camera
client in another process and the reference in this one make the same
bytes.
"""

from __future__ import annotations

import numpy as np

INTRUDER_SHARE = 0.25  # of chunks that hold the intruder, over their middle half


def _rng(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed) & (2**64 - 1), *keys]))


def _background(size: int) -> np.ndarray:
    rows = np.arange(size, dtype=np.int32)
    base = np.stack([50 + rows // 4, 50 + rows // 4, 60 + rows // 4], axis=-1)
    return np.broadcast_to(base[:, None, :], (size, size, 3)).astype(np.uint8)


def _draw_disk(img: np.ndarray, cx: float, cy: float, r: float, color, ring=None) -> None:
    """``img[disk] = color`` (and the ring ``ring = (width, color)``) with
    the generator's masks, evaluated inside the bounding box."""
    size = img.shape[0]
    reach = r + (ring[0] / 2 if ring else 0.0) + 1
    y0, y1 = max(int(np.floor(cy - reach)), 0), min(int(np.ceil(cy + reach)) + 1, size)
    x0, x1 = max(int(np.floor(cx - reach)), 0), min(int(np.ceil(cx + reach)) + 1, size)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    d2 = (xx - cx) ** 2 + (yy - cy) ** 2
    box = img[y0:y1, x0:x1]
    box[d2 <= r**2] = color
    if ring:
        width, ring_color = ring
        box[(d2 <= (r + width / 2) ** 2) & (d2 >= (r - width / 2) ** 2)] = ring_color


def stream_motion(seed: int, stream: int):
    """(phase, speed) of one stream."""
    rng = _rng(seed, 1, stream)
    return rng.uniform(0, 2 * np.pi), rng.uniform(0.12, 0.2)


def chunk_frames(seed: int, stream: int, index: int, frames: int, size: int,
                 out: np.ndarray = None) -> np.ndarray:
    """uint8 ``[frames, size, size, 3]``: frames ``[index * frames, (index +
    1) * frames)`` of ``stream``'s scene; the intruder crosses the chunk's
    middle half in a share ``INTRUDER_SHARE`` of chunks."""
    phase, speed = stream_motion(seed, stream)
    rng = _rng(seed, 2, stream, index)
    intruder = rng.random() < INTRUDER_SHARE
    if out is None:
        out = np.empty((frames, size, size, 3), np.uint8)
    out[...] = _background(size)
    center, orbit_r, r = size / 2, size * 0.27, size * 0.11
    ring = (max(size // 96, 2), (150, 150, 160))
    for k in range(frames):
        ang = phase + speed * (index * frames + k)
        cx, cy = center + orbit_r * np.cos(ang), center + orbit_r * np.sin(ang)
        _draw_disk(out[k], cx, cy, r, (200, 200, 210), ring)
        if intruder and frames // 4 <= k < 3 * frames // 4:
            ir = max(size * 0.09 + rng.normal() * size * 0.01, 2)
            _draw_disk(out[k], size - cx, size - cy, ir, (25, 25, 30))
    return out


def stream_pool(seed: int, streams: int, chunks: int, frames: int, size: int) -> np.ndarray:
    """uint8 ``[chunks, streams, frames, size, size, 3]``: pool entry ``k``
    is chunk ``k`` of every stream (a closed loop cycles through them)."""
    pool = np.empty((chunks, streams, frames, size, size, 3), np.uint8)
    for k in range(chunks):
        for s in range(streams):
            chunk_frames(seed, s, k, frames, size, out=pool[k, s])
    return pool
