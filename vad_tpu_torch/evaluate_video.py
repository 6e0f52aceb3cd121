"""Evaluate the video anomaly-detection model with the PyTorch port.

The flags of the JAX package's ``evaluate_video.py``, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch versions of the
kernels).  Three modes:

- dataset evaluation (default): AUROC, plots, visualizations and
  ``results.txt`` under ``<checkpoint dir>/evaluation/``;
- ``--video``: one video streamed with its ConvLSTM state carried across
  chunks, every frame scored once, written as an annotated mp4 with
  ``score_timeline.png``;
- ``--video-dir``: every video under a directory, batched over stream
  slots, into ``batch_scores.json`` and a timeline per video.

``--scorer latent`` scores dataset mode by the latent-distance scorer
(``eval/latent_score.py``); the streaming modes refuse it, as in the JAX
package.  ``--data-parallel`` scores dataset mode over every card, one
model replica per card, each batch split in rows.

Usage:
    python -m vad_tpu_torch.evaluate_video --checkpoint results/video_S01_x/best_model.ckpt
    python -m vad_tpu_torch.evaluate_video --checkpoint ... --video clip.mp4 --output-video o.mp4
    python -m vad_tpu_torch.evaluate_video --checkpoint ... --video-dir clips/
"""

import argparse
import sys
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Evaluate video anomaly detection model (PyTorch port)")
    parser.add_argument("--checkpoint", type=str, required=True, help="Path to model checkpoint")
    parser.add_argument("--data-dir", type=str, default="./data/IPAD", help="Path to dataset")
    parser.add_argument("--category", type=str, default=None,
                        help="Dataset category (auto-detected from checkpoint if not provided)")
    parser.add_argument("--batch-size", type=int, default=4, help="Batch size for evaluation")
    parser.add_argument("--video", type=str, default=None,
                        help="Path to single video file for inference")
    parser.add_argument("--output-video", type=str, default=None,
                        help="Path for output annotated video")
    parser.add_argument("--video-dir", type=str, default=None,
                        help="Score EVERY video file under this directory concurrently "
                             "(batched over multi-stream slots); writes batch_scores.json "
                             "+ per-video score timelines to --output-dir")
    parser.add_argument("--output-dir", type=str, default=None,
                        help="Output directory for --video-dir results "
                             "(default <checkpoint_dir>/batch_scoring)")
    parser.add_argument("--slots", type=int, default=None,
                        help="Concurrent stream slots for --video-dir "
                             "(default min(n_videos, 16))")
    parser.add_argument("--score-mode", type=str, default="mean",
                        choices=["mean", "max", "p99"],
                        help="Window score = this statistic over per-frame scores ('mean' is "
                             "the reference's whole-window mean; 'max'/'p99' key on the "
                             "worst frames)")
    parser.add_argument("--score-smooth", type=float, default=0.0, metavar="SIGMA",
                        help="Gaussian-smooth per-frame scores along time (sigma in frames) "
                             "before aggregation and frame-level metrics")
    parser.add_argument("--data-parallel", action="store_true",
                        help="Score batches data-parallel over all visible "
                             "cards (one model replica per card along the "
                             "'data' mesh axis, each batch split in rows)")
    parser.add_argument("--scorer", type=str, default="recon", choices=["recon", "latent"],
                        help="Frame score source: 'recon' = reconstruction error; 'latent' = "
                             "Mahalanobis distance of encoder features (dataset mode)")
    parser.add_argument("--latent-proj-dim", type=int, default=128,
                        help="Random-projection dimension for the latent scorer's embeddings")
    parser.add_argument("--latent-grid", type=int, default=None,
                        help="Grid size for the latent scorer's per-frame maps")
    parser.add_argument("--latent-stats", type=str, default=None,
                        help="Reuse a previously fitted latent_stats.npz")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to evaluate on: cuda (the card, the kernels) or cpu "
                             "(the plain PyTorch versions)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.scorer == "latent" and (args.video or args.video_dir):
        # fail loudly rather than silently scoring by reconstruction error
        sys.exit(
            "error: --scorer latent supports dataset evaluation only "
            "(streaming --video/--video-dir modes score by reconstruction "
            "error; drop --scorer or run without --video/--video-dir)"
        )
    print("=" * 60)
    print("VIDEO ANOMALY DETECTION EVALUATION (PyTorch)")
    print("=" * 60)
    if args.video_dir:
        from vad_tpu_torch.eval.batch_score import score_video_dir

        score_video_dir(args.checkpoint, args.video_dir, output_dir=args.output_dir,
                        num_slots=args.slots, device=args.device)
    elif args.video:
        from vad_tpu_torch.eval.video_eval import load_video_model
        from vad_tpu_torch.eval.video_render import generate_video_output

        model, _, saved = load_video_model(args.checkpoint, args.device)
        generate_video_output(
            model, None, args.video, args.output_video or "output_annotated.mp4",
            image_size=int(saved.get("image_size", 256)),
            sequence_length=int(saved.get("sequence_length", 16)),
            objective=saved.get("objective", "reconstruct") or "reconstruct",
        )
    else:
        from vad_tpu_torch.eval.video_eval import evaluate

        evaluate(args)


if __name__ == "__main__":
    main()
