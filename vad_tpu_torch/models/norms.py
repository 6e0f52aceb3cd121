"""Normalization-layer selection (the JAX package's ``make_norm``).

'batch' is Flax's ``nn.BatchNorm(momentum=0.9)``, eps 1e-5.  In eval mode
it normalizes with the running statistics (``nn.BatchNorm2d``'s own
inference path).  In train mode it follows Flax, not torch: the batch mean
and the *biased* batch variance (E[x^2] - E[x]^2, clipped at 0), reduced in
f32 whatever the input type; the running statistics move as 0.9·old +
0.1·batch, the biased variance included (torch would store the unbiased
one); the output comes back in the type of the input and the affine
parameters, as Flax returns it.

'group' is GroupNorm(8) with eps 1e-6, Flax's default: torch's own default
(1e-5) would shift outputs wherever a group's variance is small.
"""

from __future__ import annotations

import torch
from torch import nn

NORM_KINDS = ("batch", "group")
BATCH_NORM_EPS = 1e-5
BATCH_NORM_MOMENTUM = 0.9  # Flax's: weight of the old running value
GROUP_NORM_EPS = 1e-6
GROUP_NORM_GROUPS = 8  # divides every channel width both model families use


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (NCHW, any memory format) with Flax's train mode."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=BATCH_NORM_EPS, momentum=1.0 - BATCH_NORM_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # f32 at least, as Flax
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp_min(torch.square(xf).mean(dim=(0, 2, 3)) - torch.square(mean), 0.0)
        with torch.no_grad():
            self.running_mean.mul_(BATCH_NORM_MOMENTUM).add_(mean, alpha=1.0 - BATCH_NORM_MOMENTUM)
            self.running_var.mul_(BATCH_NORM_MOMENTUM).add_(var, alpha=1.0 - BATCH_NORM_MOMENTUM)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias.to(xf.dtype)[:, None, None]
        dtype = torch.promote_types(x.dtype, torch.promote_types(self.weight.dtype,
                                                                 self.bias.dtype))
        return y.to(dtype)


def make_norm(kind: str, channels: int) -> nn.Module:
    """One normalization layer over ``channels`` (NCHW, any memory format)."""
    if kind == "batch":
        return BatchNorm(channels)
    if kind == "group":
        return nn.GroupNorm(GROUP_NORM_GROUPS, channels, eps=GROUP_NORM_EPS)
    raise ValueError(f"unknown norm {kind!r}; expected one of {NORM_KINDS}")
