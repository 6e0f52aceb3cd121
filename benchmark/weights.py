"""Seeded weights, made on the device in one call.

The benchmark owns them: both the program and the reference read this
dict, and neither changes it.  Names and shapes are the ``layout`` of the
plain reference that the configuration names (``manifest.reference``).
Values follow the port's ``init_weights`` distribution
(``vad_tpu_torch/models/video_autoencoder.py``): Xavier-normal kernels and
matrices, small biases, norm scales and running statistics away from
identity so that a folded first block and inference BatchNorm are
exercised for real.  They are float32, the type the port's checkpoints
hold: its scorer casts them to its serving type itself, after folding the
first block from them.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.manifest import reference


def _std(name: str, shape) -> float:
    """Xavier-normal: a matrix [out, in]; a conv kernel [out, in, *k] or a
    ConvTranspose one [in, out, *k] of any rank, over its receptive field."""
    if name.endswith("w_h") and len(shape) == 4:  # the ConvLSTM's HWIO kernel over h
        fan_in, fan_out = 9 * shape[2], 9 * shape[3]
    else:
        receptive = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    return math.sqrt(2.0 / (fan_in + fan_out))


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    entries = reference(cfg).layout(cfg)
    total = sum(math.prod(shape) for _, shape in entries)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in entries:
        n = math.prod(shape)
        x = flat[at:at + n].reshape(shape)
        at += n
        if len(shape) >= 2:
            x = x * _std(name, shape)
        elif name.endswith("running_var"):
            x = 0.5 + 0.5 * x.abs()
        elif name.endswith("running_mean") or name.endswith("bias"):
            x = 0.05 * x
        else:  # a norm's scale
            x = 1.0 + 0.1 * x
        out[name] = x.contiguous()
    return out


def program_state_dict(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The weights as a state dict of the port's modules (which also keep a
    BatchNorm batch counter)."""
    sd = dict(weights)
    for name in weights:
        if name.endswith("running_var"):
            key = name.replace("running_var", "num_batches_tracked")
            sd[key] = torch.zeros((), dtype=torch.long, device=weights[name].device)
    return sd
