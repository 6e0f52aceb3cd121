"""The fused first encoder block on raw uint8 frames.

normalize (x/127.5 - 1) + conv3x3 SAME (3 -> 32) + inference BatchNorm
+ 2x2 max-pool + LeakyReLU(0.2) in one pass over the bytes.  The input
affine and the BatchNorm are affine maps around a linear conv, so they
fold into one plain ``[32,3,3,3]`` weight and ``[32]`` bias acting on raw
byte values (the math of the JAX package's ``fold_first_block_params``
without its TPU band layout).  Zero padding of the normalized input is
the raw value 127.5.

``fused_first_block`` launches ``csrc/first_block.cu`` for CUDA tensors
and runs ``fused_first_block_ref`` only for CPU tensors.  Both take NHWC
u8 frames ``[F,H,W,3]`` and return NHWC ``[F,H/2,W/2,32]``, contiguous —
so ``out.permute(0, 3, 1, 2)`` is already a channels-last NCHW tensor.
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
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"first_block_forward": [_P] * 4 + [_I] * 3 + [_F, _F, _I, _P]}


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


def fused_first_block(
    u8: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out_dtype=torch.float32
) -> torch.Tensor:
    """The fused block on the card (CUDA tensors, one launch counted in
    ``fused_first_block.launches``) or the plain version (CPU tensors).

    Inference only, as in the JAX package (no VJP): on the card it raises
    when autograd would have to differentiate through it."""
    if u8.device.type == "cpu":
        return fused_first_block_ref(u8, weight, bias, out_dtype)
    if torch.is_grad_enabled() and (weight.requires_grad or bias.requires_grad):
        raise RuntimeError(
            "fused_first_block is inference-only (its kernel has no backward); "
            "call it under torch.no_grad() or with weights that do not require grad"
        )
    if u8.device.type != "cuda":
        raise ValueError(f"fused_first_block: unsupported device {u8.device}")
    if u8.dtype != torch.uint8 or u8.dim() != 4 or u8.shape[-1] != 3:
        raise ValueError(f"expected uint8 [F,H,W,3], got {u8.dtype} {tuple(u8.shape)}")
    f, h, w, _ = u8.shape
    if h % 2 or w % 2:
        raise ValueError(f"fused first block needs even H and W, got {h}x{w}")
    if not u8.is_contiguous():
        raise ValueError("u8 frames must be contiguous NHWC")
    if weight.shape != (32, 3, 3, 3) or bias.shape != (32,):
        raise ValueError(f"expected weight [32,3,3,3] and bias [32], got "
                         f"{tuple(weight.shape)}, {tuple(bias.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    w_hwio = weight.to(device=u8.device, dtype=torch.float32).permute(2, 3, 1, 0).contiguous()
    b = bias.to(device=u8.device, dtype=torch.float32).contiguous()
    out = torch.empty((f, h // 2, w // 2, 32), dtype=out_dtype, device=u8.device)
    lib = _build.load(_KERNEL, _SIGNATURES)
    with torch.cuda.device(u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.first_block_forward(
            u8.data_ptr(), w_hwio.data_ptr(), b.data_ptr(), out.data_ptr(), f, h, w,
            PAD_U8, NEGATIVE_SLOPE, int(out_dtype == torch.bfloat16), stream,
        )
    _build.check(lib, _KERNEL, status)
    fused_first_block.launches += 1
    return out


fused_first_block.launches = 0
