"""Evaluate the image anomaly-detection model with the PyTorch port.

The flags of the JAX package's ``evaluate.py``, plus ``--device`` (default
``cuda``).  A checkpoint file is evaluated on its category's test split
into ``<checkpoint dir>/evaluation/``; a checkpoint DIRECTORY evaluates
every category's newest best checkpoint under it and writes the
cross-category summary (``vad_tpu_torch/campaign.py``).
``--data-parallel`` scores over every card, one model replica per card,
each batch split in rows.

Usage:
    python -m vad_tpu_torch.evaluate --checkpoint results/bottle_x/best_model.ckpt
    python -m vad_tpu_torch.evaluate --checkpoint ./results --category all
"""

import argparse
from pathlib import Path
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Evaluate anomaly detection model (PyTorch port)")
    parser.add_argument("--checkpoint", type=str, required=True,
                        help="Path to model checkpoint; a DIRECTORY (e.g. "
                             "./results) evaluates every category's newest "
                             "best checkpoint under it and writes a "
                             "cross-category summary")
    parser.add_argument("--category", type=str, default=None,
                        help="Dataset category (default: from checkpoint; "
                             "with a directory checkpoint: 'all' or a comma "
                             "list selects the campaign's categories)")
    parser.add_argument("--data-dir", type=str, default=None,
                        help="Path to dataset (default: from checkpoint; "
                             "with a directory checkpoint + '--category all' "
                             "it is also the category-discovery root — when "
                             "omitted there, categories are discovered from "
                             "the trained runs under the checkpoint dir)")
    parser.add_argument("--score-mode", type=str, default="mean",
                        choices=["mean", "max", "p99"],
                        help="Image score = this reduction of the per-pixel "
                             "error map (mean = reference behavior; max/p99 "
                             "are sensitive to small low-contrast defects)")
    parser.add_argument("--score-smooth", type=float, default=0.0,
                        help="Gaussian sigma (pixels) to blur the error map "
                             "before scoring (0 = off)")
    parser.add_argument("--data-parallel", action="store_true",
                        help="Score batches data-parallel over all visible "
                             "cards (one model replica per card along the "
                             "'data' mesh axis, each batch split in rows)")
    parser.add_argument("--scorer", type=str, default="recon",
                        choices=["recon", "latent"],
                        help="Anomaly map source: 'recon' = per-pixel "
                             "reconstruction error (reference behavior); "
                             "'latent' = per-position Mahalanobis distance "
                             "of encoder features from Gaussians fitted on "
                             "the normal training split (decoder-free, "
                             "catches defects the decoder reconstructs too "
                             "well; stats saved to evaluation/latent_stats.npz)")
    parser.add_argument("--latent-proj-dim", type=int, default=128,
                        help="Random-projection dimension for the latent "
                             "scorer's embeddings (caps the per-position "
                             "covariance size)")
    parser.add_argument("--latent-grid", type=int, default=None,
                        help="Grid size for the latent scorer's anomaly "
                             "maps (default: middle feature layer, capped "
                             "at 32; higher = finer localization, "
                             "quadratically larger statistics)")
    parser.add_argument("--latent-stats", type=str, default=None,
                        help="Reuse a previously fitted latent_stats.npz "
                             "instead of refitting on the training split")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to evaluate on: cuda (the card) or cpu")
    return parser


def main(argv: Optional[Sequence[str]] = None):
    args = build_parser().parse_args(argv)
    if Path(args.checkpoint).is_dir():
        from vad_tpu_torch.campaign import evaluate_all

        args.results_dir = args.checkpoint
        return evaluate_all(args)
    from vad_tpu_torch.eval.image_eval import evaluate

    return evaluate(args)


if __name__ == "__main__":
    main()
