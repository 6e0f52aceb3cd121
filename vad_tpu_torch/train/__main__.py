"""Train the image anomaly-detection autoencoder with the PyTorch port
(``python -m vad_tpu_torch.train``; the ``train`` package's entry point).

The flags of the JAX package's ``train.py``, plus ``--device`` (default
``cuda``).  ``--category all`` or a comma list trains every category in
one campaign (``vad_tpu_torch/campaign.py``); ``--resume`` cannot be
combined with one.  ``--model-parallel`` > 1, ``--tensorboard``,
``--profile-dir`` and ``--debug-nans`` raise: their modules are not
ported yet.

Usage:
    python -m vad_tpu_torch.train --category synthetic --epochs 50
    python -m vad_tpu_torch.train --category all --data-dir ./data --epochs 100
"""

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m vad_tpu_torch.train",
        description="Train anomaly detection model (PyTorch port)")
    parser.add_argument("--data-dir", type=str, default="./data", help="Path to dataset")
    parser.add_argument("--category", type=str, default="synthetic",
                        help="Dataset category (e.g., bottle, synthetic); "
                             "'all' or a comma list trains every category "
                             "under --data-dir in one campaign")
    parser.add_argument("--image-size", type=int, default=256, help="Input image size")
    parser.add_argument("--latent-dim", type=int, default=256, help="Latent space dimension")
    parser.add_argument("--epochs", type=int, default=50, help="Number of training epochs")
    parser.add_argument("--batch-size", type=int, default=16, help="Batch size")
    parser.add_argument("--lr", type=float, default=1e-3, help="Learning rate")
    parser.add_argument("--num-workers", type=int, default=4, help="Decode threads")
    parser.add_argument("--loss", type=str, default="mse", choices=["mse", "ssim", "combined"],
                        help="Loss function to use")
    parser.add_argument("--ssim-weight", type=float, default=0.5,
                        help="Weight for SSIM in combined loss (0-1)")
    parser.add_argument("--results-dir", type=str, default="./results",
                        help="Directory to save results")
    parser.add_argument("--resume", type=str, default=None,
                        help="Checkpoint to resume training from")
    parser.add_argument("--seed", type=int, default=0, help="Init PRNG seed")
    parser.add_argument("--norm", type=str, default="batch", choices=["batch", "group"],
                        help="Normalization: batch (reference parity) or group "
                             "(per-sample stats; immune to padded small batches)")
    parser.add_argument("--stem", type=str, default="pool", choices=["pool", "stride2"],
                        help="Encoder downsampling: pool (reference parity: "
                             "conv+conv+2x2 max-pool per block) or stride2 "
                             "(TPU-first: the first conv of each block runs "
                             "with stride 2 — same parameter count, the "
                             "full-resolution intermediate is never "
                             "materialized and the pool backward disappears; "
                             "the JAX package's numbers in COMPONENTS.md)")
    parser.add_argument("--model-parallel", type=int, default=1,
                        help="Tensor-parallel mesh axis size (devices split "
                             "into data x model; 1 = pure data parallelism)")
    parser.add_argument("--debug-nans", action="store_true",
                        help="Raise on the first NaN produced on device")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="Write a profiler trace of one epoch here (not ported yet)")
    parser.add_argument("--tensorboard", action="store_true",
                        help="Also write epoch metrics as TensorBoard "
                             "scalars under <run_dir>/tb/ (the reference "
                             "ships tensorboard but never writes to it)")
    parser.add_argument("--precision", type=str, default="f32",
                        choices=["f32", "bf16"],
                        help="Train-step compute precision: f32 (reference "
                             "parity) or bf16 mixed precision (f32 master "
                             "weights/moments, bf16 forward+backward)")
    parser.add_argument("--accum-steps", type=int, default=1, dest="accum_steps",
                        help="Gradient accumulation: split each batch into N "
                             "microbatches run one after another in a step "
                             "(activation memory of one microbatch, one Adam "
                             "update per batch)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to train on: cuda (the card) or cpu")
    return parser


def main(argv: Optional[Sequence[str]] = None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.category == "all" or "," in (args.category or ""):
        if args.resume:
            parser.error(
                "--resume cannot be combined with a multi-category campaign "
                "('all' or a comma list): one checkpoint path cannot apply "
                "to every category. Resume each category individually."
            )
        from vad_tpu_torch.campaign import train_all

        return train_all(args)
    from vad_tpu_torch.train.image_trainer import train

    return train(args)


if __name__ == "__main__":
    main()
