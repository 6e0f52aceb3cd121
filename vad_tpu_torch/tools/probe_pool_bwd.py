"""Probe of kernel 5, the tie-splitting 2x2 max-pool backward.

The counterpart of the JAX package's ``tools/probe_pool_bwd.py``.  At each
of the video encoder's four pool inputs (B*T frames, default 128 = the
training batch of 8 windows of 16 frames), in f32 and bf16, with ties
split (``cnt_mode`` "full") and not ("nocnt"), it prints one JSON line:

- ``ms``: ``max_pool2x2_backward`` (the kernel), warmed up;
- ``library_ms``: ``torch.ops.aten.max_pool2d_with_indices_backward`` on
  the channels-last view, the backward the port's train step runs today,
  with the forward's indices made beforehand and not timed.  It reads
  int64 indices ([N,C,H/2,W/2], 8 bytes each) that the kernel does not
  need, and sends g to one index per window;
- ``plain_ms``: ``max_pool2x2_backward_ref``;
- ``bound_ms``: (2|x| + |g|) bytes over the card's memory rate, the JAX
  probe's floor at this card's bandwidth, and ``x_floor`` = ms / bound_ms;
- ``max_abs_err``: the kernel against its plain version.

Times are CUDA events on the card.  ``--device cpu`` runs the plain
version (host clock; no bound) at a size given by ``--frames``/``--image``.

Usage:
    python -m vad_tpu_torch.tools.probe_pool_bwd
    python -m vad_tpu_torch.tools.probe_pool_bwd --device cpu --frames 2 --image 16
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vad_tpu_torch.core.config import VideoAEConfig
from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.models.video_autoencoder import ENCODER_WIDTHS
from vad_tpu_torch.ops.pool_bwd import max_pool2x2_backward, max_pool2x2_backward_ref
from vad_tpu_torch.utils.profiling import device_peaks, time_ms

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
CNT_MODES = {"full": True, "nocnt": False}
SEED = 0


def pool_shapes(frames: int, image: int) -> List[Tuple[int, int, int, int]]:
    """The default video encoder's four max-pool inputs, NHWC."""
    widths = (*ENCODER_WIDTHS, VideoAEConfig().latent_dim)
    return [(frames, image >> i, image >> i, c) for i, c in enumerate(widths)]


def probe(shape, dtype: str, cnt_mode: str, device: torch.device) -> dict:
    """One probe line for NHWC ``shape`` (normal random x and g)."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    n, h, w, c = shape
    x = torch.randn(shape, generator=gen, device=device).to(DTYPES[dtype])
    g = torch.randn((n, h // 2, w // 2, c), generator=gen, device=device).to(DTYPES[dtype])
    count = CNT_MODES[cnt_mode]
    err = float((max_pool2x2_backward(x, g, count=count).float()
                 - max_pool2x2_backward_ref(x, g, count=count).float()).abs().max())
    x_cl, g_cl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)  # channels-last NCHW views
    _, indices = F.max_pool2d(x_cl, 2, return_indices=True)
    rec = {
        "probe": "pool_bwd", "shape": list(shape), "dtype": dtype, "cnt_mode": cnt_mode,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "ms": time_ms(lambda: max_pool2x2_backward(x, g, count=count), device),
        "library_ms": time_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
            g_cl, x_cl, [2, 2], [2, 2], [0, 0], [1, 1], False, indices), device),
        "plain_ms": time_ms(lambda: max_pool2x2_backward_ref(x, g, count=count), device,
                            iters=3, warmup=1),
        "bytes": (2 * x.numel() + g.numel()) * x.element_size(),
        "bound_ms": None, "bound_by": None, "x_floor": None, "max_abs_err": err,
    }
    if device.type == "cuda":
        peak_bw = device_peaks(rec["device"])[3]
        rec.update(bound_ms=rec["bytes"] / peak_bw * 1e3, bound_by="bytes")
        rec["x_floor"] = rec["ms"] / rec["bound_ms"]
    return rec


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Probe of the 2x2 max-pool backward kernel")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the kernel, timed on the card) or cpu (the plain version)")
    parser.add_argument("--frames", type=int, default=128,
                        help="Frames per pool input (B*T of the training step)")
    parser.add_argument("--image", type=int, default=256, help="Frame size")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    records = []
    for shape in pool_shapes(args.frames, args.image):
        for dtype in DTYPES:
            for cnt_mode in CNT_MODES:
                records.append(probe(shape, dtype, cnt_mode, device))
                print(json.dumps(records[-1]), flush=True)
    return records


if __name__ == "__main__":
    main()
