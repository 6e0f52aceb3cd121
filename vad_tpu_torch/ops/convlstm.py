"""The ConvLSTM serving recurrence: plain PyTorch version and CUDA kernel.

The input half of the gate convolution (conv(x, Wx) + b over all B*T
frames) is computed outside, as one batched convolution; what stays
sequential is

    gates_t = gates_x[:, t] + conv3x3_SAME(h_{t-1}, Wh)      (i, f, g, o)
    c_t = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)
    h_t = sigmoid(o) * tanh(c_t)

Layouts follow the JAX package: ``gates_x [B,T,H,W,4C]``, ``w_h
[3,3,C,4C]`` (HWIO: tap-major rows of the recurrence's matrix product),
``h0, c0 [B,H,W,C]``.  (h, c) are carried in f32 whatever the gates'
type; h is cast to the weights' type before the hidden convolution and
``h_seq`` comes out in the gates' type.

``convlstm_recurrence`` launches ``csrc/convlstm_serving.cu`` for CUDA
tensors and runs ``convlstm_recurrence_ref`` only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from vad_tpu_torch.ops import _build

State = Tuple[torch.Tensor, torch.Tensor]

_KERNEL = "convlstm_serving"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"convlstm_serving_forward": [_P] * 6 + [_I] * 6 + [_P]}


def convlstm_step(
    gates_x_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor, w_h_oihw: torch.Tensor
) -> State:
    """One ConvLSTM update given the precomputed input contribution.

    ``gates_x_t [B,H,W,4C]``, ``h, c [B,H,W,C]``, ``w_h_oihw [4C,C,3,3]``.
    The convolution runs in the weights' type, the gate math in the
    carry's type (the JAX package's ``convlstm_step``)."""
    conv = F.conv2d(h.to(w_h_oihw.dtype).permute(0, 3, 1, 2), w_h_oihw, padding=1)
    gates = gates_x_t + conv.permute(0, 2, 3, 1)
    i, f, g, o = gates.to(c.dtype).chunk(4, dim=-1)
    c_next = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_next = torch.sigmoid(o) * torch.tanh(c_next)
    return h_next, c_next


def convlstm_recurrence_ref(
    gates_x: torch.Tensor, w_h: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tuple[torch.Tensor, State]:
    """Plain PyTorch recurrence (the JAX package's ``lax.scan`` path).

    Returns ``(h_seq [B,T,H,W,C] in the gates' type, (h_T, c_T) in f32)``."""
    w_oihw = w_h.permute(3, 2, 0, 1)
    h, c = h0.float(), c0.float()
    outs = []
    for t in range(gates_x.shape[1]):
        h, c = convlstm_step(gates_x[:, t], h, c, w_oihw)
        outs.append(h.to(gates_x.dtype))
    return torch.stack(outs, dim=1), (h, c)


def convlstm_recurrence(
    gates_x: torch.Tensor, w_h: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tuple[torch.Tensor, State]:
    """The recurrence on the card (CUDA tensors) or the plain version (CPU
    tensors); same contract as ``convlstm_recurrence_ref``.

    On the card: one kernel launch per time step (T per call), each counted
    in ``convlstm_recurrence.launches``."""
    if gates_x.device.type == "cpu":
        return convlstm_recurrence_ref(gates_x, w_h, h0, c0)
    if gates_x.device.type != "cuda":
        raise ValueError(f"convlstm_recurrence: unsupported device {gates_x.device}")
    b, t, hgt, wid, four_c = gates_x.shape
    ch = four_c // 4
    if gates_x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gates_x must be float32 or bfloat16, got {gates_x.dtype}")
    if not gates_x.is_contiguous() or t < 1:
        raise ValueError(f"gates_x must be contiguous [B,T>=1,H,W,4C], "
                         f"got {tuple(gates_x.shape)}")
    if four_c != 4 * ch or w_h.shape != (3, 3, ch, four_c):
        raise ValueError(f"w_h must be [3,3,{ch},{four_c}], got {tuple(w_h.shape)}")
    if w_h.dtype != gates_x.dtype:  # the kernel runs the hidden conv in one type
        raise TypeError(f"w_h is {w_h.dtype}, gates_x {gates_x.dtype}: the kernel "
                        "needs one type for both")
    if h0.shape != (b, hgt, wid, ch) or c0.shape != h0.shape:
        raise ValueError(f"h0/c0 must be {(b, hgt, wid, ch)}, "
                         f"got {tuple(h0.shape)}/{tuple(c0.shape)}")
    for name, tensor in (("w_h", w_h), ("h0", h0), ("c0", c0)):
        if tensor.device != gates_x.device:
            raise ValueError(f"{name} is on {tensor.device}, gates_x on {gates_x.device}")

    w = w_h.contiguous()
    h0_in = h0.to(gates_x.dtype).contiguous()  # the conv's input at t = 0
    c = c0.to(torch.float32, copy=True).contiguous()  # updated in place
    h_final = torch.empty(h0.shape, dtype=torch.float32, device=gates_x.device)
    h_seq = torch.empty((b, t, hgt, wid, ch), dtype=gates_x.dtype, device=gates_x.device)
    lib = _build.load(_KERNEL, _SIGNATURES)
    with torch.cuda.device(gates_x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.convlstm_serving_forward(
            gates_x.data_ptr(), w.data_ptr(), h0_in.data_ptr(), c.data_ptr(),
            h_seq.data_ptr(), h_final.data_ptr(), b, t, hgt, wid, ch,
            int(gates_x.dtype == torch.bfloat16), stream,
        )
    _build.check(lib, _KERNEL, status)
    convlstm_recurrence.launches += t
    return h_seq, (h_final, c)


convlstm_recurrence.launches = 0
