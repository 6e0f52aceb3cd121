"""Inference BatchNorm folded into a convolution, and the one pass that
finishes each folded block of the video autoencoder's scoring step, and
each folded 3-D layer of MemAE's (kernel 7).

In eval mode BatchNorm is an affine map per channel, ``BN(y) = (y - mu) s
+ beta`` with ``s = gamma / sqrt(var + eps)``, and a convolution is linear,
so ``BN(conv(x, w) + b) = conv(x, w s) + (b - mu) s + beta``: the scale goes
into the weight's output channels (dim 0 of a ``Conv2d`` or ``Conv3d``
weight, dim 1 of a ``ConvTranspose2d`` or ``ConvTranspose3d`` one) and the
rest into the bias.  ``fold_conv_bn`` is that math, for any convolution;
which layers of a model it folds is the model's own
(``models/video_autoencoder.fold_for_scoring``,
``models/memae.fold_for_scoring``).

What is left of a folded block after the bias-free convolution is
``block_epilogue``, in one of four modes:

- ``encoder``: ``leaky_relu(max_pool2x2(y) + b, 0.2)``.  The pool comes
  first, exactly: ``b`` is constant per channel and the sign of the
  BatchNorm scale is already in the weight;
- ``decoder``: ``relu(y + b)``;
- ``last``: ``tanh(y + b)`` on the 3-channel output;
- ``leaky``: ``leaky_relu(y + b, 0.2)``, MemAE's folded layers (a
  channels-last-3d ``[N, C, T, H, W]`` output passed as the NHWC frames
  ``[N*T, H, W, C]``: the pass is per pixel).

Both versions compute in f32 and round once to ``y``'s type.
``block_epilogue`` launches ``csrc/block_epilogue.cu`` for CUDA tensors
(one launch counted in ``block_epilogue.launches``) and runs
``block_epilogue_ref`` only for CPU tensors.  ``y`` is a channels-last NCHW
tensor (an NHWC tensor's ``permute(0, 3, 1, 2)``, what cuDNN returns for
channels-last inputs); the result comes back the same way.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from vad_tpu_torch.ops import _build

BN_EPS = 1e-5
NEGATIVE_SLOPE = 0.2
MODES = ("encoder", "decoder", "last", "leaky")

_KERNEL = "block_epilogue"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"block_epilogue_forward": [_P] * 3 + [_I] * 6 + [_F, _P]}

Layer = Tuple[torch.Tensor, torch.Tensor]  # (folded weight, f32 bias)


def fold_conv_bn(weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
                 var: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, out_dim: int,
                 *, eps: float = BN_EPS) -> Layer:
    """``(weight * s, (bias - mean) * s + shift)`` with ``s = scale /
    sqrt(var + eps)`` along the weight's output-channel dim ``out_dim``,
    computed in float64 and returned as f32."""
    s = scale.detach().double() / torch.sqrt(var.detach().double() + eps)
    shape = [1] * weight.dim()
    shape[out_dim] = -1
    w = weight.detach().double() * s.reshape(shape)
    b = (bias.detach().double() - mean.detach().double()) * s + shift.detach().double()
    return w.float(), b.float()


def block_epilogue_ref(y: torch.Tensor, bias: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain PyTorch version: ``y [N,C,H,W]`` -> the mode's function of
    ``y + bias`` (module docstring), in f32 and cast once to y's type."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    yf = y.float()
    b = bias.to(device=y.device, dtype=torch.float32).reshape(1, -1, 1, 1)
    if mode == "encoder":
        out = F.leaky_relu(F.max_pool2d(yf, 2) + b, NEGATIVE_SLOPE)
    elif mode == "leaky":
        out = F.leaky_relu(yf + b, NEGATIVE_SLOPE)
    elif mode == "decoder":
        out = torch.relu(yf + b)
    else:
        out = torch.tanh(yf + b)
    return out.to(y.dtype)


def _check_args(y: torch.Tensor, bias: torch.Tensor, mode: str) -> torch.Tensor:
    """y as a contiguous NHWC tensor, after the kernel's own checks."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if torch.is_grad_enabled() and (y.requires_grad or bias.requires_grad):
        raise RuntimeError("block_epilogue is inference-only (its kernel has no backward); "
                           "call it under torch.no_grad()")
    if y.dim() != 4 or y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"expected a 4-D f32 or bf16 y, got {y.dtype} {tuple(y.shape)}")
    n, c, h, w = y.shape
    x = y.permute(0, 2, 3, 1)
    if not x.is_contiguous():
        raise ValueError("y must be channels-last (an NHWC tensor viewed as NCHW)")
    if bias.shape != (c,) or bias.dtype != torch.float32:
        raise ValueError(f"expected an f32 bias [{c}], got {bias.dtype} {tuple(bias.shape)}")
    if mode != "last" and (c % 8 or x.data_ptr() % 16):
        raise ValueError(f"the {mode} mode needs C % 8 == 0 and a 16-byte aligned y; "
                         f"got C={c}")
    if mode == "encoder" and (h % 2 or w % 2):
        raise ValueError(f"the encoder mode pools 2x2 and needs even H and W, got {h}x{w}")
    if mode != "last" and n * h * w * c // 8 >= 2**30:
        raise ValueError(f"block_epilogue: {tuple(y.shape)} has 2^30 or more channel groups")
    if y.device.type != "cuda" or bias.device != y.device:
        raise ValueError(f"block_epilogue: unsupported devices {y.device}, {bias.device}")
    return x


def block_epilogue(y: torch.Tensor, bias: torch.Tensor, mode: str) -> torch.Tensor:
    """The epilogue on the card (CUDA tensors, f32 or bf16, one launch) or
    the plain version (CPU tensors).  ``bias`` is f32 ``[C]``."""
    if y.device.type == "cpu":
        return block_epilogue_ref(y, bias, mode)
    x = _check_args(y, bias, mode)
    n, h, w, c = x.shape
    oh, ow = (h // 2, w // 2) if mode == "encoder" else (h, w)
    out = torch.empty((n, oh, ow, c), dtype=x.dtype, device=x.device)
    if out.numel():
        lib = _build.load(_KERNEL, _SIGNATURES)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = lib.block_epilogue_forward(
                x.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h, w, c, MODES.index(mode),
                int(x.dtype == torch.bfloat16), NEGATIVE_SLOPE, stream,
            )
        _build.check(lib, _KERNEL, status)
        block_epilogue.launches += 1
    return out.permute(0, 3, 1, 2)


block_epilogue.launches = 0
