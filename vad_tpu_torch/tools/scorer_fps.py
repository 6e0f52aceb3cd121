"""Scoring frames/s of the default video model at one frame size, on the card.

The bench's scoring line (``vad_tpu_torch.bench.measure``: S streams of
T-frame chunks cycled from the synthetic 720p source resized to the frame
size, seeded weights, the carried (h, c) in f32, best of 4 windows each
ended by a fetch) at ``--image-size``, so a frame size the bench does not
run (512x512 streams: a 32x32 latent) can be timed, and two checkouts can
be held against each other in one call.  It prints one JSON line with the
frames/s, the launches of kernels 1 and 4 over the measurement, the plan
of kernel 1 at that size, the card's name and its power limit.

Usage:
    python -m vad_tpu_torch.tools.scorer_fps [--image-size 512] [--form fused]
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from vad_tpu_torch import bench
from vad_tpu_torch.core.config import VideoAEConfig
from vad_tpu_torch.ops import convlstm, encoder_fused


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--image-size", type=int, default=512)
    parser.add_argument("--streams", type=int, default=bench.STREAMS)
    parser.add_argument("--chunk", type=int, default=16)
    parser.add_argument("--form", choices=bench.FORMS, default="fused")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scorer_fps: no CUDA device (torch.cuda.is_available() is False)")
    device = torch.device("cuda")
    cfg = VideoAEConfig(image_size=args.image_size, sequence_length=args.chunk)
    src = bench.make_source_frames(bench.N_SOURCE, args.image_size)
    model = bench.video_model(device, cfg=cfg)
    convlstm.convlstm_recurrence.launches = encoder_fused.fused_first_block.launches = 0
    fps, _ = bench.measure(device, args.form, args.chunk, src=src, streams=args.streams,
                           model=model)
    lat = args.image_size // 16
    plan = convlstm.recurrence_plan("convlstm_serving", args.streams, args.chunk, lat, lat,
                                    cfg.lstm_hidden_dim, torch.bfloat16)
    rec = {"tool": "scorer_fps", "image_size": args.image_size, "streams": args.streams,
           "chunk": args.chunk, "form": args.form, "dtype": "bfloat16", "frames_per_s": fps,
           "launches": {"convlstm_serving": convlstm.convlstm_recurrence.launches,
                        "first_block": encoder_fused.fused_first_block.launches},
           "kernel1_design": plan.design, "device": torch.cuda.get_device_name(0),
           "power_limit_w": bench.power_limit_w()}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
