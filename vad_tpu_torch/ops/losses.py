"""Reconstruction losses: MSE, SSIM, and their weighted combination.

A copy of the JAX package's ``vad_tpu/ops/losses.py`` (same constants: an
11x11 Gaussian window with sigma 1.5, SAME padding, C1 = 0.01^2, C2 =
0.03^2).  SSIM's local statistics are depthwise convolutions
(``F.conv2d`` with ``groups=C``); XLA computes them outside any Pallas
kernel too.

All functions take NHWC (or ``[B,T,H,W,C]``, flattened to frames) tensors
in the [-1, 1] range; the scalar losses return 0-d tensors, the
per-sample ones ``[B]``.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

SSIM_C1 = 0.01**2
SSIM_C2 = 0.03**2


@functools.lru_cache(maxsize=None)
def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    """Normalized 2D Gaussian [size, size] (outer product of 1D), host f32."""
    coords = np.arange(size, dtype=np.float32) - size // 2
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    g = g / np.sum(g)
    return np.outer(g, g)


def _flatten_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, *x.shape[2:]) if x.dim() == 5 else x


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements."""
    return torch.mean(torch.square(pred - target))


def ssim(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM map between two NHWC batches (Gaussian-weighted local
    statistics, SAME padding)."""
    pred, target = _flatten_to_nhwc(pred), _flatten_to_nhwc(target)
    channels = pred.shape[-1]
    win = torch.as_tensor(_gaussian_window(window_size, sigma), dtype=pred.dtype,
                          device=pred.device)
    kernel = win.expand(channels, 1, window_size, window_size)
    pad = window_size // 2  # SAME for an odd window

    def conv(x):
        return F.conv2d(x.permute(0, 3, 1, 2), kernel, padding=pad, groups=channels)

    mu_p, mu_t = conv(pred), conv(target)
    mu_pp, mu_tt, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    var_p = conv(pred * pred) - mu_pp
    var_t = conv(target * target) - mu_tt
    cov = conv(pred * target) - mu_pt
    ssim_map = ((2.0 * mu_pt + SSIM_C1) * (2.0 * cov + SSIM_C2)) / (
        (mu_pp + mu_tt + SSIM_C1) * (var_p + var_t + SSIM_C2)
    )
    return torch.mean(ssim_map)


def ssim_loss(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11,
              sigma: float = 1.5) -> torch.Tensor:
    """1 - SSIM, so lower is better."""
    return 1.0 - ssim(pred, target, window_size, sigma)


def combined_loss(pred: torch.Tensor, target: torch.Tensor, alpha: float = 0.5,
                  window_size: int = 11) -> torch.Tensor:
    """(1-alpha)*MSE + alpha*SSIM-loss."""
    return (1.0 - alpha) * mse_loss(pred, target) + alpha * ssim_loss(pred, target, window_size)


def mse_per_sample(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-sample MSE [B]; mean(mse_per_sample) == mse_loss."""
    d = torch.square(pred - target)
    return torch.mean(d.reshape(d.shape[0], -1), dim=1)


def ssim_per_sample(pred: torch.Tensor, target: torch.Tensor, window_size: int = 11,
                    sigma: float = 1.5) -> torch.Tensor:
    """Per-sample SSIM loss [B]: 1 - the mean SSIM map of each sample.  A
    ``[B,T,H,W,C]`` sample's T frames form one joint SSIM."""
    if pred.dim() == 5:
        return torch.stack([1.0 - ssim(p, t, window_size, sigma) for p, t in zip(pred, target)])
    return torch.stack([1.0 - ssim(p[None], t[None], window_size, sigma)
                        for p, t in zip(pred, target)])


def combined_per_sample(pred: torch.Tensor, target: torch.Tensor, alpha: float = 0.5,
                        window_size: int = 11) -> torch.Tensor:
    return (1.0 - alpha) * mse_per_sample(pred, target) + alpha * ssim_per_sample(
        pred, target, window_size
    )


def make_per_sample_loss_fn(name: str, ssim_weight: float = 0.5) -> Callable:
    """Per-sample loss by CLI name {mse, ssim, combined}."""
    if name == "mse":
        return mse_per_sample
    if name == "ssim":
        return ssim_per_sample
    if name == "combined":
        return functools.partial(combined_per_sample, alpha=ssim_weight)
    raise ValueError(f"unknown loss '{name}' (expected mse|ssim|combined)")


def make_loss_fn(name: str, ssim_weight: float = 0.5) -> Callable:
    """Batch-mean loss by CLI name {mse, ssim, combined}."""
    if name == "mse":
        return mse_loss
    if name == "ssim":
        return ssim_loss
    if name == "combined":
        return functools.partial(combined_loss, alpha=ssim_weight)
    raise ValueError(f"unknown loss '{name}' (expected mse|ssim|combined)")
