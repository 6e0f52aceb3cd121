"""Convolutional autoencoder for image anomaly detection (PyTorch port of
the JAX package's ``vad_tpu/models/autoencoder.py``; 1,546,147 parameters
at the defaults).

Encoder: 4 blocks of (conv3x3 + norm + LeakyReLU(0.2) + conv3x3 + norm,
2x2 max-pool, LeakyReLU(0.2)), channels 3->32->64->128->latent, spatial
/16.  Decoder: 3 blocks of (ConvTranspose 2x2/2 + norm + ReLU + conv3x3 +
norm + ReLU), channels latent->128->64->32, then ConvTranspose 2x2/2 +
norm + ReLU + conv3x3 to the image channels + tanh.  No Pallas kernel
runs in the JAX model, so cuDNN computes every convolution here.

Public functions keep the JAX layout (NHWC images in [-1, 1]); inside,
NHWC tensors are viewed as channels-last NCHW.  Modules follow
``train()``/``eval()``: BatchNorm uses batch statistics in train mode
(Flax's semantics, ``models/norms.py``); the scoring methods are the JAX
model's ``train=False`` calls, so run them in eval mode.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vad_tpu_torch.core.config import ImageAEConfig
from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.models.norms import make_norm
from vad_tpu_torch.models.video_autoencoder import (
    DECODER_WIDTHS,
    ENCODER_WIDTHS,
    NEGATIVE_SLOPE,
    _nchw,
    _nhwc,
)

STEMS = ("pool", "stride2")


def same_pad_stride2(size: int) -> Tuple[int, int]:
    """JAX's "SAME" padding (before, after) of a 3x3 stride-2 conv over
    ``size`` pixels: (0, 1) on even sizes, where torch's ``padding=1``
    would pad (1, 1); (1, 1) on odd ones."""
    total = max(((size + 1) // 2 - 1) * 2 + 3 - size, 0)
    return total // 2, total - total // 2


class EncoderBlock(nn.Module):
    """Two conv3x3 + norm stages; LeakyReLU(0.2) after the first, and after
    the 2x2 max-pool that follows the second (LeakyReLU is monotone, so the
    pool commutes with it and the activation runs on 1/4 the pixels).

    ``stem='stride2'`` runs the first conv at stride 2 and drops the pool:
    the same parameters, another function."""

    def __init__(self, in_channels: int, features: int, norm: str = "batch",
                 stem: str = "pool"):
        super().__init__()
        if stem not in STEMS:
            raise ValueError(f"unknown stem {stem!r}; expected one of {STEMS}")
        self.stem = stem
        stride, pad = (2, 0) if stem == "stride2" else (1, 1)
        self.conv1 = nn.Conv2d(in_channels, features, 3, stride=stride, padding=pad)
        self.norm1 = make_norm(norm, features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.norm2 = make_norm(norm, features)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        """NCHW in, NCHW out."""
        if self.stem == "stride2":
            (top, bottom), (left, right) = (same_pad_stride2(n) for n in y.shape[2:])
            y = F.pad(y, (left, right, top, bottom))
        y = F.leaky_relu(self.norm1(self.conv1(y)), NEGATIVE_SLOPE)
        y = self.norm2(self.conv2(y))
        if self.stem == "pool":
            y = F.max_pool2d(y, 2)
        return F.leaky_relu(y, NEGATIVE_SLOPE)


class Encoder(nn.Module):
    """``[B,H,W,C]`` -> ``[B,H/16,W/16,latent]``."""

    def __init__(self, in_channels: int = 3, latent_dim: int = 256, norm: str = "batch",
                 stem: str = "pool"):
        super().__init__()
        widths = (*ENCODER_WIDTHS, latent_dim)
        cins = (in_channels, *widths[:-1])
        self.blocks = nn.ModuleList(
            EncoderBlock(ci, co, norm, stem) for ci, co in zip(cins, widths))

    def forward(self, x: torch.Tensor, *, return_pyramid: bool = False):
        """``return_pyramid``: also return every block's output, in block
        order (the finest first; the latent scorer's input)."""
        y = _nchw(x)
        pyramid = []
        for block in self.blocks:
            y = block(y)
            pyramid.append(y)
        out = _nhwc(y)
        if return_pyramid:
            return out, tuple(_nhwc(f) for f in pyramid)
        return out


class DecoderBlock(nn.Module):
    """ConvTranspose 2x2/2 + norm + ReLU, then conv3x3 + norm + ReLU."""

    def __init__(self, in_channels: int, features: int, norm: str = "batch"):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(in_channels, features, 2, stride=2)
        self.norm1 = make_norm(norm, features)
        self.conv = nn.Conv2d(features, features, 3, padding=1)
        self.norm2 = make_norm(norm, features)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.deconv(y)))
        return F.relu(self.norm2(self.conv(y)))


class Decoder(nn.Module):
    """``[B,h,w,latent]`` -> ``[B,16h,16w,C]`` in [-1, 1] (tanh)."""

    def __init__(self, out_channels: int = 3, latent_dim: int = 256, norm: str = "batch"):
        super().__init__()
        cins = (latent_dim, *DECODER_WIDTHS[:-1])
        self.blocks = nn.ModuleList(
            DecoderBlock(ci, co, norm) for ci, co in zip(cins, DECODER_WIDTHS))
        last = DECODER_WIDTHS[-1]
        self.deconv = nn.ConvTranspose2d(last, last, 2, stride=2)
        self.norm = make_norm(norm, last)
        self.conv = nn.Conv2d(last, out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        y = _nchw(z)
        for block in self.blocks:
            y = block(y)
        y = F.relu(self.norm(self.deconv(y)))
        return _nhwc(torch.tanh(self.conv(y)))


class ConvAutoencoder(nn.Module):
    """Encoder -> decoder with the anomaly scores of the JAX model.
    ``device=None`` means CUDA and raises when there is none."""

    def __init__(self, in_channels: int = 3, latent_dim: int = 256, norm: str = "batch",
                 stem: str = "pool", device=None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels, self.latent_dim, self.norm, self.stem = (
            in_channels, latent_dim, norm, stem)
        self.encoder = Encoder(in_channels, latent_dim, norm, stem)
        self.decoder = Decoder(in_channels, latent_dim, norm)
        self.to(device)

    @classmethod
    def from_config(cls, cfg: ImageAEConfig, device=None) -> "ConvAutoencoder":
        return cls(cfg.in_channels, cfg.latent_dim, cfg.norm, cfg.stem, device=device)

    @property
    def device(self) -> torch.device:
        return self.decoder.conv.weight.device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B,H,W,C]`` -> reconstruction ``[B,H,W,C]``."""
        return self.decoder(self.encoder(x))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The latent ``[B,H/16,W/16,latent]`` without decoding."""
        return self.encoder(x)

    def feature_pyramid(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Each encoder block's output ``[B,H/2^k,W/2^k,C_k]``, in block
        order (the finest first; the latent scorer's input).  Run it in eval
        mode."""
        return self.encoder(x, return_pyramid=True)[1]

    def error_map(self, x: torch.Tensor) -> torch.Tensor:
        """Per-pixel anomaly map ``[B,H,W]``: channel-mean squared error."""
        return torch.mean(torch.square(x - self(x)), dim=-1)

    def reconstruction_error(self, x: torch.Tensor, per_pixel: bool = False) -> torch.Tensor:
        """``[B,H,W]`` maps if ``per_pixel`` else ``[B]`` scores: the channel
        mean first, then the spatial mean (the JAX model's order)."""
        err = self.error_map(x)
        return err if per_pixel else torch.mean(err, dim=(1, 2))
