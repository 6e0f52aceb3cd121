"""Optimizer and plateau learning-rate schedule (the JAX package's
``vad_tpu/train/state.py``).

Adam with L2 weight decay coupled before the moments: torch's
``Adam(weight_decay=wd)`` adds ``wd * param`` to the gradient before
``scale_by_adam``, which is optax's ``add_decayed_weights(wd)`` then
``scale_by_adam()`` (betas 0.9/0.999, eps 1e-8 outside the square root on
both sides).  The learning rate lives in ``param_groups``, so the host-side
plateau controller changes it between epochs.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float,
                   weight_decay: float = 1e-5) -> torch.optim.Adam:
    """Adam with torch-semantics (coupled) weight decay."""
    return torch.optim.Adam(params, lr=learning_rate, weight_decay=weight_decay)


def current_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class ReduceLROnPlateau:
    """Host-side plateau controller (torch semantics: rel threshold 1e-4,
    cooldown 0, min_lr 0); a copy of the JAX package's."""

    def __init__(
        self,
        mode: str = "min",
        factor: float = 0.5,
        patience: int = 5,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
    ) -> None:
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = math.inf if mode == "min" else -math.inf
        self.num_bad = 0

    def _is_better(self, value: float) -> bool:
        if self.mode == "min":
            return value < self.best * (1.0 - self.threshold)
        return value > self.best * (1.0 + self.threshold)

    def step(self, value: float, lr: float) -> float:
        """Feed the epoch metric; returns the (possibly reduced) LR."""
        if self._is_better(value):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            lr = max(lr * self.factor, self.min_lr)
            self.num_bad = 0
        return lr
