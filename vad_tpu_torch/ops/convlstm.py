"""The ConvLSTM recurrence: plain PyTorch versions and CUDA kernels.

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

Three kernels, each with its plain version beside it:

- kernel 1, ``csrc/convlstm_serving.cu`` (``convlstm_recurrence`` without
  autograd; plain version ``convlstm_recurrence_ref``);
- kernel 2, the same source built with ``STORE_CELL``: the training
  forward, which also stores ``c_seq`` in the gates' type
  (``convlstm_train_forward``; plain version ``convlstm_forward_ref(...,
  with_cell_seq=True)``);
- kernel 3, ``csrc/convlstm_backward.cu``: reverse time, recomputing the
  gates from ``h_seq``/``c_seq`` (``convlstm_backward``; plain version
  ``convlstm_backward_ref``).

Each has two designs, and ``recurrence_plan`` picks one from the shape and
type alone: *resident* (bf16 frames of at most 256 pixels in 8x8 tiles:
weights and the frame stay in shared memory, wgmma and TMA, one launch for
kernels 1 and 2 and four for kernel 3) or *stepwise* (everything else:
f32, ragged frames and widths; one launch per step).

``convlstm_recurrence`` is the one entry point.  When autograd records
(grad enabled and an input requires grad) it goes through
``ConvLSTMRecurrence`` — kernel 2 forward, kernel 3 backward, the
counterpart of the JAX package's ``jax.custom_vjp`` — else through
kernel 1, the split JAX makes between the primal and ``_fwd``.  Each
wrapper launches its kernel for CUDA tensors and runs its plain version
only for CPU tensors.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vad_tpu_torch.ops import _build

State = Tuple[torch.Tensor, torch.Tensor]

_KERNEL = "convlstm_serving"
_BWD_KERNEL = "convlstm_backward"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "convlstm_serving_forward": [_P] * 7 + [_I] * 7 + [_P],
    "convlstm_train_forward": [_P] * 8 + [_I] * 7 + [_P],
    "convlstm_serving_active_clusters": [_I] * 5,
}
_BWD_SIGNATURES = {
    "convlstm_backward": [_P] * 14 + [_I] * 9 + [_P],
    "convlstm_backward_active_clusters": [_I] * 4,
}
_DESIGN_CODES = {"stepwise": 0, "resident": 1}

NUM_SMS = 132  # H100 SXM
_NT = 64  # wgmma N: GEMM columns of a resident block
_STEP_TILE = (64, 128)  # the stepwise core's output tile (pixels, columns)
_STEP_SMEM = 41_472  # the stepwise core's static shared memory (3-stage ring)
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use (csrc/convlstm_tiles.cuh)


@dataclass(frozen=True)
class RecurrencePlan:
    """How one call of a recurrence kernel runs on the card.

    ``design`` is ``"resident"`` or ``"stepwise"``; ``grids`` names each
    launch's grid, ``cluster`` the blocks per cluster (1: none),
    ``smem_bytes`` the largest block's shared memory, ``launches`` the
    launches per call (what the kernel's counter adds), ``scratch_bytes``
    the device scratch the wrapper allocates for the call."""

    kernel: str
    design: str
    launches: int
    cluster: int
    smem_bytes: int
    scratch_bytes: int
    grids: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    gate_groups: int = 0  # kernel 3 resident: frame groups of the gate launch
    dw_splits: int = 0  # kernel 3: K splits of the dWh launch


_KERNELS = ("convlstm_serving", "convlstm_train_forward", "convlstm_backward")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _even_splits(units: int, most: int) -> int:
    """At most ``most`` splits of ``units`` into equal runs, none empty."""
    return _cdiv(units, _cdiv(units, max(1, min(units, most))))


def _plane_bytes(hgt: int, wid: int) -> int:
    """One padded 8-channel plane of a frame in shared memory (TMA
    destinations are 128-byte aligned)."""
    return _cdiv((hgt + 2) * (wid + 2) * 16, 128) * 128


def _resident_smem(kernel: str, hgt: int, wid: int, ch: int) -> int:
    """Dynamic shared memory of the resident design's largest block: the
    padded frame's C/8 planes and a 16-channel x 4-gate slice of Wh (kernel
    3: its gate, reverse-loop and dWh launches)."""
    frame = ch // 8 * _plane_bytes(hgt, wid)
    wh_slice = 9 * ch * _NT * 2
    if kernel != "convlstm_backward":
        return frame + wh_slice + 16  # + the TMA mbarrier
    hw = hgt * wid
    return max(frame + wh_slice + 16,  # gate launch
               max(frame, hw * _NT * 4) + wh_slice,  # reverse loop
               frame + 8 * hw * 16 + 16)  # dWh


def resident_fits(kernel: str, hgt: int, wid: int, ch: int, dtype: torch.dtype) -> bool:
    """Whether the resident design takes this shape: bf16 (wgmma), a
    frame of at most four 8x8 pixel tiles (one per warpgroup), 16 hidden
    channels a block of a cluster of at most 8; kernel 3 also needs rows
    of 16 pixels (its dWh walks K in 16-pixel runs) and 64 output channels
    a block of its dh product.  Its blocks' shared memory must also fit
    the H100's ``SMEM_LIMIT`` (an 8x32 or 32x8 frame at C=128 does not)."""
    fits = (dtype == torch.bfloat16 and hgt % 8 == 0 and wid % 8 == 0
            and (hgt // 8) * (wid // 8) <= 4 and ch % 16 == 0 and ch <= 128)
    if kernel == "convlstm_backward":
        fits = fits and wid % 16 == 0 and ch % 64 == 0
    return fits and _resident_smem(kernel, hgt, wid, ch) <= SMEM_LIMIT


def recurrence_plan(kernel: str, b: int, t: int, hgt: int, wid: int, ch: int,
                    dtype: torch.dtype, design: Optional[str] = None) -> RecurrencePlan:
    """The design, grids, cluster size, shared memory, launches per call
    and scratch of ``kernel`` (``"convlstm_serving"``, ``"convlstm_train_forward"``
    or ``"convlstm_backward"``) at ``gates_x [b, t, hgt, wid, 4*ch]`` of
    ``dtype``.  ``design=None`` takes the resident design wherever it fits,
    else the stepwise one; naming a design that does not fit raises."""
    if kernel not in _KERNELS:
        raise ValueError(f"unknown recurrence kernel {kernel!r}")
    fits = resident_fits(kernel, hgt, wid, ch, dtype)
    if design is None:
        design = "resident" if fits else "stepwise"
    elif design not in _DESIGN_CODES:
        raise ValueError(f"unknown design {design!r}")
    elif design == "resident" and not fits:
        raise ValueError(f"the resident design does not take {kernel} at "
                         f"B={b} T={t} {hgt}x{wid} C={ch} {dtype}")
    hw, four_c = hgt * wid, 4 * ch
    act_bytes = b * t * hw * four_c * 4  # kernel 3's f32 gate activations
    if kernel != "convlstm_backward":
        if design == "resident":
            return RecurrencePlan(kernel, design, launches=1, cluster=ch // 16,
                                  smem_bytes=_resident_smem(kernel, hgt, wid, ch),
                                  scratch_bytes=0, grids={"recurrence": (ch // 16, b)})
        return RecurrencePlan(kernel, design, launches=t, cluster=1, smem_bytes=_STEP_SMEM,
                              scratch_bytes=0,
                              grids={"step": (_cdiv(b * hw, _STEP_TILE[0]), _cdiv(ch, 32))})
    if design == "resident":
        blocks = ch // 16
        gate_groups = max(1, min(b * t, NUM_SMS // blocks))
        dw_blocks = 3 * four_c // _NT
        splits = _even_splits(b * t, 2 * NUM_SMS // dw_blocks)
        return RecurrencePlan(
            kernel, design, launches=4, cluster=blocks,
            smem_bytes=_resident_smem(kernel, hgt, wid, ch),
            scratch_bytes=act_bytes + splits * 9 * ch * four_c * 4,
            grids={"gate": (blocks, gate_groups), "loop": (blocks, b),
                   "dw": (dw_blocks, splits), "dw_reduce": (_cdiv(9 * ch * four_c, 256),)},
            gate_groups=gate_groups, dw_splits=splits)
    step = (_cdiv(b * hw, _STEP_TILE[0]), _cdiv(ch, _STEP_TILE[1]))
    dw_tiles = (_cdiv(9 * ch, 64), _cdiv(four_c, _STEP_TILE[1]))
    stages = _cdiv(b * t * hw, 64 // (2 if dtype == torch.bfloat16 else 4))  # 64-byte K stages
    splits = _even_splits(stages, 2 * NUM_SMS // (dw_tiles[0] * dw_tiles[1]))
    return RecurrencePlan(
        kernel, design, launches=t + 3, cluster=1, smem_bytes=_STEP_SMEM,
        scratch_bytes=act_bytes + splits * 9 * ch * four_c * 4,
        grids={"gate": (_cdiv(b * t * hw, _STEP_TILE[0]), _cdiv(ch, 32)), "step": step,
               "dw": dw_tiles + (splits,),
               "finish": (step[0] * step[1] + _cdiv(9 * ch * four_c, 256),)},
        dw_splits=splits)


def active_clusters(kernel: str, b: int, hgt: int, wid: int, ch: int) -> int:
    """Clusters of ``kernel``'s resident launch (kernels 1 and 2: the
    recurrence; kernel 3: its reverse loop) that the card holds at once,
    from ``cudaOccupancyMaxActiveClusters`` (CUDA only)."""
    if kernel == "convlstm_backward":
        lib = _build.load(_BWD_KERNEL, _BWD_SIGNATURES)
        return lib.convlstm_backward_active_clusters(b, hgt, wid, ch)
    lib = _build.load(_KERNEL, _SIGNATURES)
    return lib.convlstm_serving_active_clusters(b, hgt, wid, ch,
                                                int(kernel == "convlstm_train_forward"))


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


def _scan(gates_x, w_h, h0, c0, with_cell_seq: bool, remat: bool):
    w_oihw = w_h.permute(3, 2, 0, 1)
    h, c = h0.float(), c0.float()
    hs, cs = [], []
    for t in range(gates_x.shape[1]):
        if remat:
            h, c = checkpoint(convlstm_step, gates_x[:, t], h, c, w_oihw, use_reentrant=False)
        else:
            h, c = convlstm_step(gates_x[:, t], h, c, w_oihw)
        hs.append(h.to(gates_x.dtype))
        if with_cell_seq:
            cs.append(c.to(gates_x.dtype))
    c_seq = torch.stack(cs, dim=1) if with_cell_seq else None
    return torch.stack(hs, dim=1), c_seq, (h, c)


def convlstm_forward_ref(
    gates_x: torch.Tensor, w_h: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
    with_cell_seq: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], State]:
    """Plain version of kernels 1 and 2 (the JAX package's ``_run_forward``).

    Returns ``(h_seq, c_seq, (h_T, c_T))``: ``h_seq`` and (with
    ``with_cell_seq``, else None) ``c_seq [B,T,H,W,C]`` in the gates'
    type, as ``_forward_kernel`` stores them; the finals in f32."""
    return _scan(gates_x, w_h, h0, c0, with_cell_seq, remat=False)


def convlstm_recurrence_ref(
    gates_x: torch.Tensor, w_h: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
    remat: bool = False,
) -> Tuple[torch.Tensor, State]:
    """Plain PyTorch recurrence (the JAX package's ``lax.scan`` path),
    differentiable by autograd.

    Returns ``(h_seq [B,T,H,W,C] in the gates' type, (h_T, c_T) in f32)``.
    ``remat`` recomputes each step in the backward pass
    (``torch.utils.checkpoint`` per step, the scan's ``jax.checkpoint``)."""
    h_seq, _, final = _scan(gates_x, w_h, h0, c0, False, remat)
    return h_seq, final


def convlstm_backward_ref(
    gates_x: torch.Tensor, w_h: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
    h_seq: torch.Tensor, c_seq: torch.Tensor, dh_seq: torch.Tensor,
    dhf: torch.Tensor, dcf: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel 3: the JAX package's ``_backward_kernel``
    (``convlstm_pallas.py:398-508``) as an explicit reverse-time loop.

    For t = T-1 .. 0: recompute the gates from ``h_{t-1}`` (``h0`` at
    t = 0), form ``dc_total`` and ``d(i, f, g, o)``, accumulate ``dWh +=
    im2col(h_{t-1})^T . dgates``, carry ``dh_{t-1}`` (the full correlation
    of dgates with the flipped taps) and ``dc_{t-1} = dc_total * f``.  The
    carries and the gate math are f32.  The dgates that feed ``dWh`` and
    ``dh_{t-1}`` are the stored ones, in the gates' type (kernel 3 reads
    them back; in f32 this is exactly the Pallas kernel).  ``dhf``/``dcf``
    are cast to the gates' type first, as ``_bwd`` does.

    Returns ``(dgates_x in the gates' type, dWh in w_h's type, dh0, dc0 in
    h0's and c0's types)``."""
    dt = gates_x.dtype
    b, t_len, hgt, wid, four_c = gates_x.shape
    ch = four_c // 4
    w32 = w_h.float().permute(3, 2, 0, 1)  # [4C, C, 3, 3]
    w_corr = w32.transpose(0, 1).flip(2, 3)  # [C, 4C, 3, 3]: taps reversed
    h0_in = h0.to(dt)  # the conv's input at t = 0, as the forward used it
    dh, dc = dhf.to(dt).float(), dcf.to(dt).float()
    dgates_x = torch.empty_like(gates_x)
    dw = torch.zeros((ch * 9, four_c), dtype=torch.float32, device=gates_x.device)
    for t in reversed(range(t_len)):
        h_prev = (h0_in if t == 0 else h_seq[:, t - 1]).float().permute(0, 3, 1, 2)
        c_prev = c0.float() if t == 0 else c_seq[:, t - 1].float()
        acc = gates_x[:, t].float() + F.conv2d(h_prev, w32, padding=1).permute(0, 2, 3, 1)
        i, f, o = (torch.sigmoid(a) for a in (acc[..., :ch], acc[..., ch:2 * ch],
                                              acc[..., 3 * ch:]))
        g = torch.tanh(acc[..., 2 * ch:3 * ch])
        tanh_ct = torch.tanh(c_seq[:, t].float())
        dh_total = dh_seq[:, t].float() + dh
        dc_total = dc + dh_total * o * (1.0 - tanh_ct * tanh_ct)
        dgates = torch.cat([
            dc_total * g * i * (1.0 - i),
            dc_total * c_prev * f * (1.0 - f),
            dc_total * i * (1.0 - g * g),
            dh_total * tanh_ct * o * (1.0 - o),
        ], dim=-1)
        dgates_x[:, t] = dgates.to(dt)
        dg = dgates_x[:, t].float()
        h_cat = F.unfold(h_prev, 3, padding=1)  # [B, C*9, H*W], rows (c, dy, dx)
        dw += torch.einsum("bkp,bpn->kn", h_cat, dg.reshape(b, hgt * wid, four_c))
        dh = F.conv2d(dg.permute(0, 3, 1, 2), w_corr, padding=1).permute(0, 2, 3, 1)
        dc = dc_total * f
    dw_h = dw.reshape(ch, 3, 3, four_c).permute(1, 2, 0, 3)
    return dgates_x, dw_h.to(w_h.dtype), dh.to(h0.dtype), dc.to(c0.dtype)


def _validate(who: str, gates_x, w_h, h0, c0) -> Tuple[int, int, int, int, int]:
    """Shape, type and device checks of a CUDA call; returns (B, T, H, W, C)."""
    if gates_x.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {gates_x.device}")
    b, t, hgt, wid, four_c = gates_x.shape
    ch = four_c // 4
    if gates_x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"gates_x must be float32 or bfloat16, got {gates_x.dtype}")
    if t < 1:
        raise ValueError(f"gates_x must be [B,T>=1,H,W,4C], got {tuple(gates_x.shape)}")
    if four_c != 4 * ch or w_h.shape != (3, 3, ch, four_c):
        raise ValueError(f"w_h must be [3,3,{ch},{four_c}], got {tuple(w_h.shape)}")
    if w_h.dtype != gates_x.dtype:  # the kernels run the hidden conv in one type
        raise TypeError(f"w_h is {w_h.dtype}, gates_x {gates_x.dtype}: the kernel "
                        "needs one type for both")
    if h0.shape != (b, hgt, wid, ch) or c0.shape != h0.shape:
        raise ValueError(f"h0/c0 must be {(b, hgt, wid, ch)}, "
                         f"got {tuple(h0.shape)}/{tuple(c0.shape)}")
    for name, tensor in (("w_h", w_h), ("h0", h0), ("c0", c0)):
        if tensor.device != gates_x.device:
            raise ValueError(f"{name} is on {tensor.device}, gates_x on {gates_x.device}")
    return b, t, hgt, wid, ch


def _w_t(w_h: torch.Tensor) -> torch.Tensor:
    """``w_h`` per tap transposed, ``[9, 4C, C]`` (the kernels' B layout)."""
    ch = w_h.shape[2]
    return w_h.reshape(9, ch, 4 * ch).transpose(1, 2).contiguous()


def _forward_kernel(gates_x, w_h, h0, c0, with_cell_seq: bool,
                    plan: Optional[RecurrencePlan] = None):
    """Kernel 1 (or kernel 2 with ``with_cell_seq``) on the card, in the
    design of ``plan`` (``recurrence_plan``'s choice when None); adds the
    plan's launches to the kernel's counter."""
    who = "convlstm_train_forward" if with_cell_seq else "convlstm_serving"
    b, t, hgt, wid, ch = _validate(who, gates_x, w_h, h0, c0)
    if plan is None:
        plan = recurrence_plan(who, b, t, hgt, wid, ch, gates_x.dtype)
    gx, w = gates_x.contiguous(), w_h.contiguous()
    w_t = _w_t(w) if plan.design == "resident" else w
    h0_in = h0.to(gates_x.dtype).contiguous()  # the conv's input at t = 0
    c = c0.to(torch.float32, copy=True).contiguous()  # updated in place
    h_final = torch.empty(h0.shape, dtype=torch.float32, device=gx.device)
    seq_shape = (b, t, hgt, wid, ch)
    h_seq = torch.empty(seq_shape, dtype=gx.dtype, device=gx.device)
    c_seq = torch.empty(seq_shape, dtype=gx.dtype, device=gx.device) if with_cell_seq else None
    lib = _build.load(_KERNEL, _SIGNATURES)
    with torch.cuda.device(gx.device):
        stream = torch.cuda.current_stream().cuda_stream
        shape = (b, t, hgt, wid, ch, int(gx.dtype == torch.bfloat16),
                 _DESIGN_CODES[plan.design], stream)
        if with_cell_seq:
            status = lib.convlstm_train_forward(
                gx.data_ptr(), w.data_ptr(), w_t.data_ptr(), h0_in.data_ptr(), c.data_ptr(),
                h_seq.data_ptr(), c_seq.data_ptr(), h_final.data_ptr(), *shape)
        else:
            status = lib.convlstm_serving_forward(
                gx.data_ptr(), w.data_ptr(), w_t.data_ptr(), h0_in.data_ptr(), c.data_ptr(),
                h_seq.data_ptr(), h_final.data_ptr(), *shape)
    _build.check(lib, _KERNEL, status)
    counter = convlstm_train_forward if with_cell_seq else convlstm_recurrence
    counter.launches += plan.launches
    return h_seq, c_seq, (h_final, c)


def convlstm_train_forward(
    gates_x: torch.Tensor, w_h: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, State]:
    """Kernel 2 (CUDA tensors only): the recurrence that also stores
    ``c_seq``; same contract as ``convlstm_forward_ref(...,
    with_cell_seq=True)``.  Launches per call as ``recurrence_plan`` says
    (1 resident, T stepwise), counted in ``convlstm_train_forward.launches``."""
    return _forward_kernel(gates_x, w_h, h0, c0, with_cell_seq=True)


def _backward_kernel(gates_x, w_h, h0, c0, h_seq, c_seq, dh_seq, dhf, dcf,
                     plan: Optional[RecurrencePlan] = None):
    """Kernel 3 on the card in the design of ``plan`` (``recurrence_plan``'s
    choice when None); adds the plan's launches to its counter."""
    b, t, hgt, wid, ch = _validate("convlstm_backward", gates_x, w_h, h0, c0)
    seq_shape = (b, t, hgt, wid, ch)
    for name, tensor in (("h_seq", h_seq), ("c_seq", c_seq), ("dh_seq", dh_seq)):
        if tensor.shape != seq_shape or tensor.device != gates_x.device:
            raise ValueError(f"{name} must be {seq_shape} on {gates_x.device}, got "
                             f"{tuple(tensor.shape)} on {tensor.device}")
    if dhf.shape != h0.shape or dcf.shape != h0.shape:
        raise ValueError(f"dhf/dcf must be {tuple(h0.shape)}")
    dt = gates_x.dtype
    if plan is None:
        plan = recurrence_plan("convlstm_backward", b, t, hgt, wid, ch, dt)
    gx, w = gates_x.contiguous(), w_h.contiguous()
    w_t = _w_t(w)
    h0_in = h0.to(dt).contiguous()
    c0f = c0.to(torch.float32).contiguous()
    hs, cs, dhs = (x.to(dt).contiguous() for x in (h_seq, c_seq, dh_seq))
    # carries, f32, updated in place; seeded as _bwd seeds them
    dh_carry = dhf.to(dt).to(torch.float32, copy=True).contiguous()
    dc_carry = dcf.to(dt).to(torch.float32, copy=True).contiguous()
    dgates_x = torch.empty_like(gx)
    dw = torch.empty((3, 3, ch, 4 * ch), dtype=torch.float32, device=gx.device)
    # scratch for this call only (plan.scratch_bytes): the f32 gate
    # activations and the dWh partials of each K split
    act = torch.empty((b, t, hgt, wid, 4 * ch), dtype=torch.float32, device=gx.device)
    part = torch.empty((plan.dw_splits, 9 * ch, 4 * ch), dtype=torch.float32, device=gx.device)
    lib = _build.load(_BWD_KERNEL, _BWD_SIGNATURES)
    with torch.cuda.device(gx.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.convlstm_backward(
            gx.data_ptr(), w.data_ptr(), w_t.data_ptr(), h0_in.data_ptr(), c0f.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(), dh_carry.data_ptr(),
            dc_carry.data_ptr(), dgates_x.data_ptr(), dw.data_ptr(), act.data_ptr(),
            part.data_ptr(),
            b, t, hgt, wid, ch, int(dt == torch.bfloat16), _DESIGN_CODES[plan.design],
            plan.gate_groups, plan.dw_splits, stream,
        )
    _build.check(lib, _BWD_KERNEL, status)
    convlstm_backward.launches += plan.launches
    return dgates_x, dw.to(w_h.dtype), dh_carry.to(h0.dtype), dc_carry.to(c0.dtype)


def convlstm_backward(
    gates_x: torch.Tensor, w_h: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
    h_seq: torch.Tensor, c_seq: torch.Tensor, dh_seq: torch.Tensor,
    dhf: torch.Tensor, dcf: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel 3 (CUDA tensors only); same contract as
    ``convlstm_backward_ref``.  Launches per call as ``recurrence_plan``
    says (4 resident, T + 3 stepwise), counted in
    ``convlstm_backward.launches``."""
    return _backward_kernel(gates_x, w_h, h0, c0, h_seq, c_seq, dh_seq, dhf, dcf)


class ConvLSTMRecurrence(torch.autograd.Function):
    """The recurrence with a hand-written backward (the JAX package's
    ``convlstm_recurrence_pallas`` custom VJP): kernel 2 forward and
    kernel 3 backward on the card, their plain versions on the CPU.

    ``apply(gates_x, w_h, h0, c0) -> (h_seq, h_T, c_T)``."""

    @staticmethod
    def forward(ctx, gates_x, w_h, h0, c0):
        # a final state the loss never uses arrives as zeros, not None
        ctx.set_materialize_grads(True)
        if gates_x.device.type == "cpu":
            h_seq, c_seq, (hf, cf) = convlstm_forward_ref(gates_x, w_h, h0, c0,
                                                          with_cell_seq=True)
        else:
            h_seq, c_seq, (hf, cf) = convlstm_train_forward(gates_x, w_h, h0, c0)
        ctx.save_for_backward(gates_x, w_h, h0, c0, h_seq, c_seq)
        return h_seq, hf, cf

    @staticmethod
    def backward(ctx, dh_seq, dhf, dcf):
        saved = ctx.saved_tensors
        backward = convlstm_backward_ref if saved[0].device.type == "cpu" else convlstm_backward
        return backward(*saved, dh_seq, dhf, dcf)


def convlstm_recurrence(
    gates_x: torch.Tensor, w_h: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
    remat: bool = False,
) -> Tuple[torch.Tensor, State]:
    """The recurrence; same contract as ``convlstm_recurrence_ref``.

    Under autograd (grad enabled, an input requiring grad) it runs
    ``ConvLSTMRecurrence``: kernels 2 and 3 on the card.  Otherwise kernel
    1 on the card (launches per call as ``recurrence_plan`` says, counted
    in ``convlstm_recurrence.launches``), or the plain version for CPU
    tensors.  ``remat`` is accepted and does nothing here, as on the JAX
    package's Pallas path: the backward already recomputes the gates."""
    del remat
    if gates_x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"convlstm_recurrence: unsupported device {gates_x.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (gates_x, w_h, h0, c0)):
        h_seq, hf, cf = ConvLSTMRecurrence.apply(gates_x, w_h, h0, c0)
        return h_seq, (hf, cf)
    if gates_x.device.type == "cpu":
        return convlstm_recurrence_ref(gates_x, w_h, h0, c0)
    h_seq, _, final = _forward_kernel(gates_x, w_h, h0, c0, with_cell_seq=False)
    return h_seq, final


convlstm_recurrence.launches = 0
convlstm_train_forward.launches = 0
convlstm_backward.launches = 0
