"""Train and eval steps (the JAX package's ``vad_tpu/train/steps.py``,
without a mesh).

A train step does: u8 normalization, forward in train mode (BatchNorm on
batch statistics), the masked mean of the per-sample losses over the
first ``n_real`` samples, backward, and one optimizer step.  PyTorch runs
it eagerly; on the card the ConvLSTM goes through kernels 2 and 3.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.func import functional_call


def u8_normalize(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [-1, 1] (the framework's normalization contract)."""
    return x.float() / 127.5 - 1.0


def make_train_step(per_sample_loss_fn: Callable, compute_dtype: Optional[torch.dtype] = None,
                    accum_steps: int = 1) -> Callable:
    """``step(model, optimizer, images_u8, n_real) -> loss`` (a detached f32
    0-d tensor on the model's device).

    The loss is a masked mean over the first ``n_real`` samples, so padded
    tail entries contribute nothing to it or its gradients (they do enter
    train-mode BatchNorm statistics, as in the JAX package).

    ``compute_dtype`` (e.g. ``torch.bfloat16``) is mixed precision: the
    parameters are cast inside the differentiated forward
    (``functional_call`` with ``p.to(dtype)``), so the gradients reach the
    f32 master weights in f32; the input goes in that type; BatchNorm
    running statistics stay f32 buffers; the loss is computed in f32.
    ``None`` is full f32.

    ``accum_steps`` > 1 splits the batch into that many microbatches, each
    forward+backward in turn: the gradients are the sum over microbatches
    of the masked loss sums, divided once by ``n_real`` (equal to the
    full-batch masked mean), then one optimizer step.  BatchNorm normalizes
    each microbatch by its own statistics and its running statistics
    advance once per microbatch.  The batch must divide by ``accum_steps``.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def forward(model, x):
        if compute_dtype is None:
            return model(x)
        params = {name: p.to(compute_dtype) for name, p in model.named_parameters()}
        return functional_call(model, params, (x.to(compute_dtype),))

    def step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
             images_u8: torch.Tensor, n_real: int) -> torch.Tensor:
        batch = images_u8.shape[0]
        if batch % accum_steps:
            raise ValueError(f"batch size {batch} not divisible by accum_steps {accum_steps}")
        micro = batch // accum_steps
        denom = float(max(int(n_real), 1))
        mask = torch.arange(batch, device=images_u8.device) < int(n_real)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss_sum = torch.zeros((), dtype=torch.float32, device=images_u8.device)
        for k in range(accum_steps):
            x = u8_normalize(images_u8[k * micro:(k + 1) * micro])
            losses = per_sample_loss_fn(forward(model, x).float(), x)
            micro_sum = torch.sum(torch.where(mask[k * micro:(k + 1) * micro], losses, 0.0))
            (micro_sum / denom).backward()
            loss_sum += micro_sum.detach()
        optimizer.step()
        return loss_sum / denom

    return step


def make_eval_step(per_sample_loss_fn: Callable, score_method: Callable) -> Callable:
    """``step(model, images_u8) -> (per-sample losses [B], scores)``.

    Runs in eval mode (BatchNorm on running statistics) under
    ``torch.no_grad()``, so on the card the recurrence is kernel 1, and
    restores the model's mode after.  ``score_method(model, x)`` computes
    the anomaly scores (e.g. per-frame reconstruction error)."""

    @torch.no_grad()
    def step(model: torch.nn.Module, images_u8: torch.Tensor):
        was_training = model.training
        model.eval()
        try:
            x = u8_normalize(images_u8)
            losses = per_sample_loss_fn(model(x), x)
            scores = score_method(model, x)
        finally:
            model.train(was_training)
        return losses, scores

    return step
