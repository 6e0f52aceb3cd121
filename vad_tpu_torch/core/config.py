"""Model configuration dataclasses (a copy of the JAX package's; the
JAX package has no MemAE, so ``MemAEConfig`` is the port's own).

Checkpoints persist the CLI ``args`` dict and every consumer rebuilds the
model from it, so these round-trip through dicts with the same key names
and defaults as ``vad_tpu/core/config.py``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class ImageAEConfig:
    """Image conv-autoencoder hyperparameters."""

    in_channels: int = 3
    latent_dim: int = 256
    image_size: int = 256
    norm: str = "batch"  # 'group': per-sample stats (models/norms.py)
    stem: str = "pool"  # 'stride2': downsample in the conv, no max-pool

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_args(cls, args: Dict[str, Any]) -> "ImageAEConfig":
        return cls(
            in_channels=int(args.get("in_channels", 3)),
            latent_dim=int(args.get("latent_dim", 256)),
            image_size=int(args.get("image_size", 256)),
            norm=str(args.get("norm", "batch")),
            stem=str(args.get("stem", "pool")),
        )


@dataclass(frozen=True)
class VideoAEConfig:
    """ConvLSTM video-autoencoder hyperparameters (2,709,411 parameters at
    the defaults)."""

    in_channels: int = 3
    latent_dim: int = 128
    lstm_hidden_dim: int = 128
    lstm_layers: int = 2
    image_size: int = 256
    sequence_length: int = 16
    norm: str = "batch"  # 'group': per-sample stats (models/norms.py)
    stem: str = "pool"  # 'stride2': downsample in the conv, no max-pool

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_args(cls, args: Dict[str, Any]) -> "VideoAEConfig":
        return cls(
            in_channels=int(args.get("in_channels", 3)),
            latent_dim=int(args.get("latent_dim", 128)),
            lstm_hidden_dim=int(args.get("lstm_hidden_dim", 128)),
            lstm_layers=int(args.get("lstm_layers", 2)),
            image_size=int(args.get("image_size", 256)),
            sequence_length=int(args.get("sequence_length", 16)),
            norm=str(args.get("norm", "batch")),
            stem=str(args.get("stem", "pool")),
        )


MEMAE = "memae"  # ``args["model"]`` of a MemAE checkpoint


@dataclass(frozen=True)
class MemAEConfig:
    """MemAE, the memory-augmented 3D-convolutional video autoencoder (Gong
    et al., ICCV 2019; ``AutoEncoderCov3DMem`` of
    github.com/donggong1/memae-anomaly-detection): 6,492,801 parameters at
    the defaults.  Checkpoints mark it with ``args["model"] == "memae"``."""

    in_channels: int = 1
    widths: Tuple[int, ...] = (96, 128, 256, 256)
    mem_dim: int = 2000
    shrink_thres: float = 0.0025
    image_size: int = 256
    sequence_length: int = 16

    def to_dict(self) -> Dict[str, Any]:
        return {"model": MEMAE, **dataclasses.asdict(self), "widths": list(self.widths)}

    @classmethod
    def from_args(cls, args: Dict[str, Any]) -> "MemAEConfig":
        return cls(
            in_channels=int(args.get("in_channels", 1)),
            widths=tuple(int(w) for w in args.get("widths", (96, 128, 256, 256))),
            mem_dim=int(args.get("mem_dim", 2000)),
            shrink_thres=float(args.get("shrink_thres", 0.0025)),
            image_size=int(args.get("image_size", 256)),
            sequence_length=int(args.get("sequence_length", 16)),
        )


def is_memae(args: Dict[str, Any]) -> bool:
    """Whether a checkpoint's ``args`` describe a MemAE model."""
    return (args or {}).get("model") == MEMAE
