"""Scoring or training frames/s of the default video model at one frame size, on the card.

The bench's scoring line (``vad_tpu_torch.bench.measure``: S streams of
T-frame chunks cycled from the synthetic 720p source resized to the frame
size, seeded weights, the carried (h, c) in f32, best of 4 windows each
ended by a fetch) at ``--image-size``, so a frame size the bench does not
run (512x512 streams: a 32x32 latent) can be timed, and two checkouts can
be held against each other in one call.  It prints one JSON line with the
frames/s, the launches of kernels 1 and 4 over the measurement, the plan
of kernel 1 at that size, the card's name and its power limit.

``--train`` times the bench's bf16 train line instead
(``bench.measure_train``: ``make_train_step`` with bf16 compute, B
windows of T frames, Adam, best of 3 windows of 8 steps), with the
launches of kernels 2 and 3 and their plans' designs.

Usage:
    python -m vad_tpu_torch.tools.scorer_fps [--image-size 512] [--form fused]
    python -m vad_tpu_torch.tools.scorer_fps --image-size 512 --train
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
    parser.add_argument("--train", action="store_true",
                        help="time the bf16 train step (the bench's B windows) instead of scoring")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scorer_fps: no CUDA device (torch.cuda.is_available() is False)")
    device = torch.device("cuda")
    cfg = VideoAEConfig(image_size=args.image_size, sequence_length=args.chunk)
    src = bench.make_source_frames(bench.N_SOURCE, args.image_size)
    model = bench.video_model(device, cfg=cfg)
    lat = args.image_size // 16
    if args.train:
        return _train(args, device, src, model, lat, cfg.lstm_hidden_dim)
    convlstm.convlstm_recurrence.launches = encoder_fused.fused_first_block.launches = 0
    fps, _ = bench.measure(device, args.form, args.chunk, src=src, streams=args.streams,
                           model=model)
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


def _train(args, device, src, model, lat: int, hidden: int) -> dict:
    """The bf16 train line at the frame size: frames/s, kernels 2 and 3's
    launches over the measurement (warm-up included) and their designs."""
    kernels = {"convlstm_train_forward": convlstm.convlstm_train_forward,
               "convlstm_backward": convlstm.convlstm_backward}
    for fn in kernels.values():
        fn.launches = 0
    batch = bench.TRAIN_BATCH
    fps, _ = bench.measure_train(device, src, torch.bfloat16, batch=batch, chunk_t=args.chunk,
                                 model=model)
    rec = {"tool": "scorer_fps", "mode": "train", "image_size": args.image_size,
           "batch": batch, "chunk": args.chunk, "dtype": "bfloat16", "frames_per_s": fps,
           "launches": {k: fn.launches for k, fn in kernels.items()},
           "designs": {k: convlstm.recurrence_plan(k, batch, args.chunk, lat, lat, hidden,
                                                   torch.bfloat16).design for k in kernels},
           "device": torch.cuda.get_device_name(0), "power_limit_w": bench.power_limit_w()}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
