"""Inference BatchNorm folded into the video autoencoder's convolutions,
and the one pass that finishes each folded block (kernel 7).

In eval mode BatchNorm is an affine map per channel, ``BN(y) = (y - mu) s
+ beta`` with ``s = gamma / sqrt(var + eps)``, and a convolution is linear,
so ``BN(conv(x, w) + b) = conv(x, w s) + (b - mu) s + beta``: the scale goes
into the weight's output channels (dim 0 of a ``Conv2d`` weight, dim 1 of a
``ConvTranspose2d`` one) and the rest into the bias.  ``fold_blocks`` does
this for encoder blocks 2-4 and decoder layers 1-3 (the last decoder layer
keeps its own weight and bias).  Block 1 is kernel 4's
(``ops/encoder_fused.py``).

What is left of a folded block after the bias-free convolution is
``block_epilogue``, in one of three modes:

- ``encoder``: ``leaky_relu(max_pool2x2(y) + b, 0.2)``.  The pool comes
  first, exactly: ``b`` is constant per channel and the sign of the
  BatchNorm scale is already in the weight;
- ``decoder``: ``relu(y + b)``;
- ``last``: ``tanh(y + b)`` on the 3-channel output.

Both versions compute in f32 and round once to ``y``'s type.
``block_epilogue`` launches ``csrc/block_epilogue.cu`` for CUDA tensors
(one launch counted in ``block_epilogue.launches``) and runs
``block_epilogue_ref`` only for CPU tensors.  ``y`` is a channels-last NCHW
tensor (an NHWC tensor's ``permute(0, 3, 1, 2)``, what cuDNN returns for
channels-last inputs); the result comes back the same way.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from vad_tpu_torch.ops import _build

BN_EPS = 1e-5
NEGATIVE_SLOPE = 0.2
MODES = ("encoder", "decoder", "last")
ENCODER_BLOCKS = (1, 2, 3)  # encoder.convs[i] after the fused first block
DECODER_NORMED = (0, 1, 2)  # decoder.deconvs[i] followed by a BatchNorm

_KERNEL = "block_epilogue"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"block_epilogue_forward": [_P] * 3 + [_I] * 6 + [_F, _P]}

Layer = Tuple[torch.Tensor, torch.Tensor]  # (folded weight, f32 bias)


class FoldedBlocks(NamedTuple):
    """The folded weights of everything after the fused first block:
    ``encoder`` blocks 2-4 (OIHW weights) and the four ``decoder`` layers
    (IOHW weights, the last one as trained), each ``(weight in the scoring
    type, bias f32)``."""

    encoder: Tuple[Layer, ...]
    decoder: Tuple[Layer, ...]


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


def fold_blocks(state_dict: Mapping[str, torch.Tensor], dtype: torch.dtype,
                device=None) -> FoldedBlocks:
    """Fold inference BatchNorm into encoder blocks 2-4 and decoder layers
    1-3 of a ``VideoAutoencoder`` state dict (norm='batch'), taken before
    any cast to the scoring type: weights cast to ``dtype``, biases kept
    f32, both on ``device``."""

    def norm(prefix: str):
        return tuple(state_dict[f"{prefix}.{k}"]
                     for k in ("running_mean", "running_var", "weight", "bias"))

    def place(layer: Layer) -> Layer:
        w, b = layer
        return w.to(device=device, dtype=dtype), b.to(device=device, dtype=torch.float32)

    encoder = tuple(place(fold_conv_bn(state_dict[f"encoder.convs.{i}.weight"],
                                       state_dict[f"encoder.convs.{i}.bias"],
                                       *norm(f"encoder.norms.{i}"), out_dim=0))
                    for i in ENCODER_BLOCKS)
    decoder = [place(fold_conv_bn(state_dict[f"decoder.deconvs.{i}.weight"],
                                  state_dict[f"decoder.deconvs.{i}.bias"],
                                  *norm(f"decoder.norms.{i}"), out_dim=1))
               for i in DECODER_NORMED]
    last = len(DECODER_NORMED)
    decoder.append(place((state_dict[f"decoder.deconvs.{last}.weight"].detach().float(),
                          state_dict[f"decoder.deconvs.{last}.bias"].detach().float())))
    return FoldedBlocks(encoder, tuple(decoder))


def step_calls(folded: FoldedBlocks, image: int) -> list:
    """``block_epilogue``'s calls in one scoring step on ``image x image``
    frames, read off the folded weights' shapes: ``(mode, channels, side of
    the convolution's output)``, encoder blocks 2-4 then the decoder's
    layers."""
    side, out = image // 2, []  # the fused first block pools once
    for w, _ in folded.encoder:
        out.append(("encoder", w.shape[0], side))
        side //= 2
    for i, (w, _) in enumerate(folded.decoder):
        side *= 2
        out.append(("last" if i == len(folded.decoder) - 1 else "decoder", w.shape[1], side))
    return out


def block_epilogue_ref(y: torch.Tensor, bias: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain PyTorch version: ``y [N,C,H,W]`` -> the mode's function of
    ``y + bias`` (module docstring), in f32 and cast once to y's type."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    yf = y.float()
    b = bias.to(device=y.device, dtype=torch.float32).reshape(1, -1, 1, 1)
    if mode == "encoder":
        out = F.leaky_relu(F.max_pool2d(yf, 2) + b, NEGATIVE_SLOPE)
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
    if y.device.type != "cuda" or bias.device != y.device:
        raise ValueError(f"block_epilogue: unsupported devices {y.device}, {bias.device}")
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
