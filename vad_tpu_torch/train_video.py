"""Train the ConvLSTM video anomaly-detection model with the PyTorch port.

The flags of the JAX package's ``train_video.py``, plus ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch versions of the
kernels).  ``--model-parallel`` > 1, ``--tensorboard``, ``--profile-dir``
and ``--debug-nans`` raise: their modules are not ported yet.

Usage:
    python -m vad_tpu_torch.train_video --category S01 --data-dir ./data/IPAD --epochs 20
"""

import argparse
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train video anomaly detection model (PyTorch port)")
    parser.add_argument("--data-dir", type=str, default="./data", help="Path to dataset")
    parser.add_argument("--category", type=str, required=True,
                        help="Dataset category (e.g., S01, R01)")
    parser.add_argument("--image-size", type=int, default=256, help="Frame size")
    parser.add_argument("--sequence-length", type=int, default=16,
                        help="Number of frames per sequence")
    parser.add_argument("--stride", type=int, default=4, help="Stride between sequences")
    parser.add_argument("--latent-dim", type=int, default=128, help="Latent space dimension")
    parser.add_argument("--lstm-hidden-dim", type=int, default=128,
                        help="ConvLSTM hidden dimension")
    parser.add_argument("--lstm-layers", type=int, default=2, help="Number of ConvLSTM layers")
    parser.add_argument("--epochs", type=int, default=50, help="Number of training epochs")
    parser.add_argument("--batch-size", type=int, default=4,
                        help="Batch size (smaller for video due to memory)")
    parser.add_argument("--lr", type=float, default=1e-4, help="Learning rate")
    parser.add_argument("--loss", type=str, default="mse",
                        choices=["mse", "ssim", "combined"],
                        help="Training loss (reference uses mse; ssim/combined "
                             "help on low-contrast structural anomalies)")
    parser.add_argument("--ssim-weight", type=float, default=0.5,
                        help="SSIM weight for the combined loss")
    parser.add_argument("--objective", type=str, default="reconstruct",
                        choices=["reconstruct", "predict"],
                        help="reconstruct = reference behavior; predict trains "
                             "output t against frame t+1 (sensitive to purely "
                             "temporal anomalies)")
    parser.add_argument("--num-workers", type=int, default=2, help="Decode threads")
    parser.add_argument("--results-dir", type=str, default="./results",
                        help="Directory to save results")
    parser.add_argument("--seed", type=int, default=0, help="Init PRNG seed")
    parser.add_argument("--keep-checkpoints", type=int, default=0,
                        dest="keep_checkpoints",
                        help="Keep only the newest N per-epoch checkpoints "
                             "(0 = keep all, the reference behavior; "
                             "best/final are never rotated)")
    parser.add_argument("--norm", type=str, default="batch", choices=["batch", "group"],
                        help="Normalization: batch (reference parity) or group "
                             "(per-sample stats; immune to padded small batches)")
    parser.add_argument("--stem", type=str, default="pool", choices=["pool", "stride2"],
                        help="Encoder downsampling: pool (reference parity: "
                             "conv+2x2 max-pool per block) or stride2 "
                             "(stride-2 convs — same parameter count, no "
                             "full-resolution intermediate, no pool backward)")
    parser.add_argument("--resume", type=str, default=None,
                        help="Checkpoint to resume training from")
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
    parser.add_argument("--remat", action="store_true",
                        help="Rematerialize ConvLSTM steps in backward "
                             "(constant activation memory over sequence length)")
    parser.add_argument("--precision", type=str, default="f32",
                        choices=["f32", "bf16"],
                        help="Train-step compute precision: f32 (reference "
                             "parity) or bf16 mixed precision (f32 master "
                             "weights/moments, bf16 forward+backward)")
    parser.add_argument("--accum-steps", type=int, default=1, dest="accum_steps",
                        help="Gradient accumulation: split each batch into N "
                             "microbatches run one after another in a step "
                             "(activation memory of one microbatch, one Adam "
                             "update per batch; composes with --remat)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to train on: cuda (the card, the kernels) or cpu "
                             "(the plain PyTorch versions)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    from vad_tpu_torch.train.video_trainer import train

    print("=" * 60)
    print("VIDEO ANOMALY DETECTION TRAINING (PyTorch)")
    print("=" * 60)
    train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
