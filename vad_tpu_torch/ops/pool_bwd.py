"""2x2/2 max-pool backward that splits the gradient across ties.

The counterpart of the JAX package's pool-backward probe kernel
(``tools/probe_pool_bwd.py`` ``make_pool_bwd``).  For ``x [N,H,W,C]`` and
the pooled gradient ``g [N,H/2,W/2,C]``, per 2x2 window and channel:

    m = max of the window (NaN if an entry is NaN); eq = x == m
    count=True:  dx = eq ? (float32(g) / number of ties -> x's type) : 0
    count=False: dx = eq ? g : 0     (every tie gets all of g)

``count=True`` is the gradient of a reshape-and-max (``jax.grad`` of
``jnp.max`` and torch autograd of ``amax`` split ties the same way).  It
is not the backward of ``F.max_pool2d``, which the training step runs:
that one sends ``g`` to a single index per window, so the two agree only
on windows without ties.

``max_pool2x2_backward`` launches ``csrc/pool_bwd.cu`` for CUDA tensors
(one launch counted in ``max_pool2x2_backward.launches``) and runs
``max_pool2x2_backward_ref`` only for CPU tensors.  Both take NHWC
contiguous tensors or channels-last NCHW views of the same memory
(``[N,C,H,W]`` whose ``permute(0, 2, 3, 1)`` is contiguous), and return
``dx`` in the layout given.  A tensor that is contiguous is read as NHWC.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from vad_tpu_torch.ops import _build

_KERNEL = "pool_bwd"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"pool_bwd_forward": [_P] * 3 + [_I] * 6 + [_P]}


def _as_nhwc(x: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """(x, g) as NHWC tensors, and whether they came as NCHW views."""
    if x.dim() != 4 or g.dim() != 4:
        raise ValueError(f"expected 4-D x and g, got {tuple(x.shape)} and {tuple(g.shape)}")
    nchw = not x.is_contiguous()
    if nchw:
        x, g = x.permute(0, 2, 3, 1), g.permute(0, 2, 3, 1)
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("x and g must be contiguous NHWC or channels-last NCHW views")
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"2x2 max-pool backward needs even H and W, got {h}x{w}")
    if tuple(g.shape) != (n, h // 2, w // 2, c):
        raise ValueError(f"g must be [N,H/2,W/2,C] = {[n, h // 2, w // 2, c]}, "
                         f"got {list(g.shape)}")
    if g.dtype != x.dtype:
        raise TypeError(f"x and g must share a dtype, got {x.dtype} and {g.dtype}")
    return x, g, nchw


def _from_nhwc(dx: torch.Tensor, nchw: bool) -> torch.Tensor:
    return dx.permute(0, 3, 1, 2) if nchw else dx


def max_pool2x2_backward_ref(
    x: torch.Tensor, g: torch.Tensor, *, count: bool = True
) -> torch.Tensor:
    """Plain PyTorch version: the same eq/count formula, the division in
    f32 and one cast to x's type at the end (as the JAX probe kernel)."""
    x, g, nchw = _as_nhwc(x, g)
    n, h, w, c = x.shape
    xw = x.reshape(n, h // 2, 2, w // 2, 2, c)
    eq = xw == xw.amax(dim=(2, 4), keepdim=True)
    gw = g.reshape(n, h // 2, 1, w // 2, 1, c)
    if count:
        ties = eq.sum(dim=(2, 4), keepdim=True, dtype=torch.float32)
        gw = (gw.float() / ties).to(x.dtype)
    dx = torch.where(eq, gw, torch.zeros((), dtype=x.dtype, device=x.device))
    return _from_nhwc(dx.reshape(n, h, w, c), nchw)


def max_pool2x2_backward(x: torch.Tensor, g: torch.Tensor, *, count: bool = True) -> torch.Tensor:
    """The pool backward on the card (CUDA tensors, f32 or bf16) or the
    plain version (CPU tensors)."""
    if x.device.type == "cpu":
        return max_pool2x2_backward_ref(x, g, count=count)
    if x.device.type != "cuda" or g.device != x.device:
        raise ValueError(f"max_pool2x2_backward: unsupported devices {x.device}, {g.device}")
    x, g, nchw = _as_nhwc(x, g)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    n, h, w, c = x.shape
    if n * (h // 2) * (w // 2) * c >= 2**31:
        raise ValueError(f"max_pool2x2_backward: {tuple(x.shape)} has 2^31 or more g entries")
    dx = torch.empty_like(x)
    if dx.numel() == 0:  # nothing to launch
        return _from_nhwc(dx, nchw)
    lib = _build.load(_KERNEL, _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.pool_bwd_forward(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), n, h, w, c,
            int(x.dtype == torch.bfloat16), int(count), stream,
        )
    _build.check(lib, _KERNEL, status)
    max_pool2x2_backward.launches += 1
    return _from_nhwc(dx, nchw)


max_pool2x2_backward.launches = 0
