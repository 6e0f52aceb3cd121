"""Normalization-layer selection (the JAX package's ``make_norm``).

'batch' is BatchNorm in inference mode (running statistics), eps 1e-5 —
Flax's default and torch's.  'group' is GroupNorm(8) with eps 1e-6, Flax's
default: torch's own default (1e-5) would shift outputs wherever a group's
variance is small.
"""

from __future__ import annotations

from torch import nn

NORM_KINDS = ("batch", "group")
BATCH_NORM_EPS = 1e-5
GROUP_NORM_EPS = 1e-6
GROUP_NORM_GROUPS = 8  # divides every channel width both model families use


def make_norm(kind: str, channels: int) -> nn.Module:
    """One normalization layer over ``channels`` (NCHW, any memory format)."""
    if kind == "batch":
        # Flax momentum 0.9 (weight of the old running value) == torch 0.1
        return nn.BatchNorm2d(channels, eps=BATCH_NORM_EPS, momentum=0.1)
    if kind == "group":
        return nn.GroupNorm(GROUP_NORM_GROUPS, channels, eps=GROUP_NORM_EPS)
    raise ValueError(f"unknown norm {kind!r}; expected one of {NORM_KINDS}")
