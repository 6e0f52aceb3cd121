"""Optimizer and plateau learning-rate schedule (the JAX package's
``vad_tpu/train/state.py``).

Adam with L2 weight decay coupled before the moments: torch's
``Adam(weight_decay=wd)`` adds ``wd * param`` to the gradient before
``scale_by_adam``, which is optax's ``add_decayed_weights(wd)`` then
``scale_by_adam()`` (betas 0.9/0.999, eps 1e-8 outside the square root on
both sides).  The learning rate lives in ``param_groups``, so the host-side
plateau controller changes it between epochs.

``load_optax_adam_state`` fills torch's Adam from the JAX package's optax
state, so a run resumed from a JAX checkpoint continues its moments, its
step count and its (plateau-reduced) learning rate.
"""

from __future__ import annotations

import math
from typing import Any, Iterable, Mapping, Optional

import torch

from vad_tpu_torch.utils.weights import flax_to_state_dict


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float,
                   weight_decay: float = 1e-5) -> torch.optim.Adam:
    """Adam with torch-semantics (coupled) weight decay."""
    return torch.optim.Adam(params, lr=learning_rate, weight_decay=weight_decay)


def current_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def _find_state(tree: Any, name: str) -> Optional[tuple]:
    """The first optax state named ``name`` in a stored state tree."""
    if type(tree).__name__ == name:
        return tree
    if isinstance(tree, (tuple, list)):
        for node in tree:
            found = _find_state(node, name)
            if found is not None:
                return found
    return None


def load_optax_adam_state(optimizer: torch.optim.Adam, model: torch.nn.Module,
                          opt_state: Any, batch_stats: Optional[Mapping] = None) -> None:
    """Fill ``optimizer`` (Adam over ``model.parameters()``, one group)
    from the JAX package's optax state as a checkpoint stores it:
    ``InjectHyperparamsState(count, hyperparams, inner_state)`` with
    ``inner_state`` = (``add_decayed_weights``, ``scale_by_adam``,
    ``scale_by_learning_rate``) states.

    ``ScaleByAdamState``'s ``mu`` and ``nu`` are trees shaped like
    ``params``; the weight bridge's layout maps (permutations, slices and
    flips) commute with elementwise moments, so they become ``exp_avg``
    and ``exp_avg_sq`` parameter by parameter.  Its ``count`` becomes each
    parameter's ``step``: optax divides by ``1 - b**count`` after its
    increment, torch by ``1 - b**step`` after its own.  The injected
    learning rate replaces every group's ``lr``.  ``batch_stats`` (the
    checkpoint's) only completes the tree the bridge reads."""
    adam = _find_state(opt_state, "ScaleByAdamState")
    if adam is None or len(opt_state) < 3 or "learning_rate" not in opt_state[1]:
        raise ValueError(f"not an injected-hyperparameter Adam state: "
                         f"{type(opt_state).__name__}")
    count, mu, nu = adam
    moments = [flax_to_state_dict(model, {"params": tree, "batch_stats": batch_stats or {}})
               for tree in (mu, nu)]
    step = float(count)
    state = {i: {"step": torch.tensor(step), "exp_avg": moments[0][name],
                 "exp_avg_sq": moments[1][name]}
             for i, (name, _) in enumerate(model.named_parameters())}
    groups = optimizer.state_dict()["param_groups"]
    for group in groups:
        group["lr"] = float(opt_state[1]["learning_rate"])
    optimizer.load_state_dict({"state": state, "param_groups": groups})


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
