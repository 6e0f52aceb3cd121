"""The fused first encoder block on raw uint8 frames.

normalize (x/127.5 - 1) + conv3x3 SAME (3 -> 32) + inference BatchNorm
+ 2x2 max-pool + LeakyReLU(0.2) in one pass over the bytes.  The input
affine and the BatchNorm are affine maps around a linear conv, so they
fold into one plain ``[32,3,3,3]`` weight and ``[32]`` bias acting on raw
byte values (the math of the JAX package's ``fold_first_block_params``
without its TPU band layout).  Zero padding of the normalized input is
the raw value 127.5.

``fused_first_block`` launches ``csrc/first_block.cu`` (kernel 4) for
CUDA tensors and runs ``fused_first_block_ref`` only for CPU tensors.
Both take NHWC u8 frames ``[F,H,W,3]`` and return NHWC ``[F,H/2,W/2,32]``,
contiguous — so ``out.permute(0, 3, 1, 2)`` is already a channels-last
NCHW tensor.

``first_block_ablate`` (kernel 6, ``csrc/first_block_ablate.cu``; plain
version ``first_block_ablate_ref``) runs the same kernel with one stage
stripped, to attribute kernel 4's time (the JAX package's
``tools/ablate_block1.py``).  Its modes, with ``xpad`` the frame padded
by one pixel of 127.5 and ``b`` the folded bias:

- ``full``: the fused block;
- ``no-epilogue``: every FMA, no max-pool and no LeakyReLU:
  ``conv(xpad)[2py, 2px] + b``;
- ``no-dot``: no FMAs, each tap reads its patch's first value:
  ``leaky(max_a xpad[2py + a//2, 2px + a%2, 0] + b)``;
- ``no-band``: no out-of-frame test, clamped reads: the fused block on an
  edge-replicated frame;
- ``dma-only``: staging and a cast store: ``out[..., c] = x[2py, 2px, c % 3]``.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vad_tpu_torch.ops import _build

IN_SCALE = 1.0 / 127.5
IN_SHIFT = -1.0
PAD_U8 = -IN_SHIFT / IN_SCALE  # raw value whose normalized image is 0
NEGATIVE_SLOPE = 0.2
BN_EPS = 1e-5

_KERNEL = "first_block"
_ABLATE_KERNEL = "first_block_ablate"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"first_block_forward": [_P] * 4 + [_I] * 3 + [_F, _F, _I, _P]}
_ABLATE_SIGNATURES = {"first_block_ablate_forward": [_I] + [_P] * 4 + [_I] * 3
                      + [_F, _F, _I, _P]}
# kernel 6's modes, in the order of csrc/first_block.cuh's Mode enum
ABLATION_MODES = ("full", "no-epilogue", "no-dot", "no-band", "dma-only")


def fold_first_block(
    weight: torch.Tensor,  # [C1,3,3,3] OIHW conv weight
    bias: torch.Tensor,  # [C1]
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    *,
    eps: float = BN_EPS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold input normalization + inference BatchNorm into (weight, bias).

    conv(a*u + s) = a*conv(u) + s*sum(W) and BN(y) = (y - mu)*g/sqrt(v+eps)
    + b, so the block is one conv with rescaled weights on raw bytes u.
    Computed in float64, returned as f32 on the weight's device."""
    w = weight.detach().double()
    s_bn = bn_scale.detach().double() / torch.sqrt(bn_var.detach().double() + eps)
    w_eff = w * IN_SCALE * s_bn[:, None, None, None]
    b_eff = (IN_SHIFT * w.sum(dim=(1, 2, 3)) + bias.detach().double()
             - bn_mean.detach().double()) * s_bn + bn_bias.detach().double()
    return w_eff.float(), b_eff.float()


def fold_from_variables(variables: Mapping) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fold_first_block`` from the JAX package's ``{"params",
    "batch_stats"}`` tree (numpy leaves).  Raises for norm='group'."""
    p = variables["params"]["encoder"]
    if "BatchNorm_0" not in p:
        raise ValueError(
            "fused input block folds inference BatchNorm into the conv; "
            "this model was built with norm='group' — use the standard path"
        )
    s = variables["batch_stats"]["encoder"]["BatchNorm_0"]
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    return fold_first_block(
        t(p["Conv_0"]["kernel"]).permute(3, 2, 0, 1), t(p["Conv_0"]["bias"]),
        t(s["mean"]), t(s["var"]), t(p["BatchNorm_0"]["scale"]), t(p["BatchNorm_0"]["bias"]),
    )


def fused_first_block_ref(
    u8: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out_dtype=torch.float32
) -> torch.Tensor:
    """Plain PyTorch version: ``u8 [F,H,W,3]`` -> ``[F,H/2,W/2,C1]``,
    computed in f32 and cast to ``out_dtype`` once at the end."""
    x = F.pad(u8.permute(0, 3, 1, 2).float(), (1, 1, 1, 1), value=PAD_U8)
    y = F.conv2d(x, weight.float(), bias.float())
    y = F.leaky_relu(F.max_pool2d(y, 2), NEGATIVE_SLOPE)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def _check_block_args(u8, weight, bias, out_dtype, name: str) -> None:
    if torch.is_grad_enabled() and (weight.requires_grad or bias.requires_grad):
        raise RuntimeError(
            f"{name} is inference-only (its kernel has no backward); "
            "call it under torch.no_grad() or with weights that do not require grad"
        )
    if u8.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {u8.device}")
    if u8.dtype != torch.uint8 or u8.dim() != 4 or u8.shape[-1] != 3:
        raise ValueError(f"expected uint8 [F,H,W,3], got {u8.dtype} {tuple(u8.shape)}")
    if u8.shape[1] % 2 or u8.shape[2] % 2:
        raise ValueError(f"fused first block needs even H and W, got "
                         f"{u8.shape[1]}x{u8.shape[2]}")
    if not u8.is_contiguous():
        raise ValueError("u8 frames must be contiguous NHWC")
    if weight.shape != (32, 3, 3, 3) or bias.shape != (32,):
        raise ValueError(f"expected weight [32,3,3,3] and bias [32], got "
                         f"{tuple(weight.shape)}, {tuple(bias.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")


def _launch_block(kernel: str, signatures: dict, lead: tuple, u8, weight, bias,
                  out_dtype) -> torch.Tensor:
    """Fold the weights into the kernel's layout, allocate the output and
    launch ``<kernel>_forward(*lead, x, w, bias, out, F, H, W, ...)``."""
    f, h, w, _ = u8.shape
    w_hwio = weight.to(device=u8.device, dtype=torch.float32).permute(2, 3, 1, 0).contiguous()
    b = bias.to(device=u8.device, dtype=torch.float32).contiguous()
    out = torch.empty((f, h // 2, w // 2, 32), dtype=out_dtype, device=u8.device)
    lib = _build.load(kernel, signatures)
    with torch.cuda.device(u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, f"{kernel}_forward")(
            *lead, u8.data_ptr(), w_hwio.data_ptr(), b.data_ptr(), out.data_ptr(), f, h, w,
            PAD_U8, NEGATIVE_SLOPE, int(out_dtype == torch.bfloat16), stream,
        )
    _build.check(lib, kernel, status)
    return out


def fused_first_block(
    u8: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out_dtype=torch.float32
) -> torch.Tensor:
    """The fused block on the card (CUDA tensors, one launch counted in
    ``fused_first_block.launches``) or the plain version (CPU tensors).

    Inference only, as in the JAX package (no VJP): on the card it raises
    when autograd would have to differentiate through it."""
    if u8.device.type == "cpu":
        return fused_first_block_ref(u8, weight, bias, out_dtype)
    _check_block_args(u8, weight, bias, out_dtype, "fused_first_block")
    out = _launch_block(_KERNEL, _SIGNATURES, (), u8, weight, bias, out_dtype)
    fused_first_block.launches += 1
    return out


fused_first_block.launches = 0


def first_block_ablate_ref(
    u8: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mode: str,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of kernel 6's ``mode`` (the module docstring
    gives each mode's function), in f32 and cast once at the end."""
    if mode not in ABLATION_MODES:
        raise ValueError(f"mode must be one of {ABLATION_MODES}, got {mode!r}")
    if mode == "full":
        return fused_first_block_ref(u8, weight, bias, out_dtype)
    if mode == "dma-only":
        channels = torch.arange(32, device=u8.device) % 3
        return u8[:, ::2, ::2, channels].to(out_dtype).contiguous()
    x = u8.permute(0, 3, 1, 2).float()
    if mode == "no-band":
        xpad = F.pad(x, (1, 1, 1, 1), mode="replicate")
    else:
        xpad = F.pad(x, (1, 1, 1, 1), value=PAD_U8)
    b = bias.float().to(u8.device)[None, :, None, None]
    if mode == "no-dot":
        h, w = x.shape[2:]
        y = F.leaky_relu(F.max_pool2d(xpad[:, :1, :h, :w], 2) + b, NEGATIVE_SLOPE)
    else:
        y = F.conv2d(xpad, weight.float().to(u8.device), bias.float().to(u8.device))
        if mode == "no-epilogue":
            y = y[:, :, ::2, ::2]
        else:
            y = F.leaky_relu(F.max_pool2d(y, 2), NEGATIVE_SLOPE)
    return y.permute(0, 2, 3, 1).to(out_dtype).contiguous()


def first_block_ablate(
    u8: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mode: str,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Kernel 6 in ``mode`` on the card (CUDA tensors, one launch counted
    in ``first_block_ablate.launches``) or its plain version (CPU
    tensors).  Inference only, like ``fused_first_block``."""
    if mode not in ABLATION_MODES:
        raise ValueError(f"mode must be one of {ABLATION_MODES}, got {mode!r}")
    if u8.device.type == "cpu":
        return first_block_ablate_ref(u8, weight, bias, mode, out_dtype)
    _check_block_args(u8, weight, bias, out_dtype, "first_block_ablate")
    out = _launch_block(_ABLATE_KERNEL, _ABLATE_SIGNATURES, (ABLATION_MODES.index(mode),),
                        u8, weight, bias, out_dtype)
    first_block_ablate.launches += 1
    return out


first_block_ablate.launches = 0
