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
  autograd; plain version ``convlstm_recurrence_ref``), and its row form
  over a frame split in row shards, each reading its neighbours' boundary
  rows of h every step (``convlstm_recurrence_rows``; plain version
  ``convlstm_recurrence_rows_ref``; the spatial row split's);
- kernel 2, the same source built with ``STORE_CELL``: the training
  forward, which also stores ``c_seq`` in the gates' type
  (``convlstm_train_forward``; plain version ``convlstm_forward_ref(...,
  with_cell_seq=True)``);
- kernel 3, ``csrc/convlstm_backward.cu``: reverse time, recomputing the
  gates from ``h_seq``/``c_seq`` (``convlstm_backward``; plain version
  ``convlstm_backward_ref``).

Each has three designs, and ``recurrence_plan`` picks one from the shape
and type alone:

- *resident* (bf16 frames of at most 256 pixels in 8x8 tiles: weights and
  the frame stay in shared memory, wgmma and TMA, one launch for kernels 1
  and 2 and four for kernel 3);
- *stepwise_tc* (f32 with C % 4 == 0, any frame; kernels 1-3 also in
  bf16 with C % 8 == 0 where the resident design refuses the frame, such as
  the 32x32 latent of 512x512 streams: one launch per step, the step's
  GEMM on the tensor cores with its K split across a thread-block cluster
  where the pixel and channel tiles alone leave SMs idle; f32 in 3xTF32,
  every f32 operand split into TF32 big and small terms (``tf32_split``),
  kernel 3's dWh and dh0 in 3xTF32 on mma.sync; bf16 on bf16 wgmma,
  kernel 3's dWh too);
- *stepwise* (everything else: ragged widths, C % 4 != 0 in f32 and C %
  8 != 0 in bf16; one launch per step on the FMA/WMMA core).  Naming it
  still runs f32 on FMAs and bf16 on WMMA.

``convlstm_recurrence`` is the one entry point.  When autograd records
(grad enabled and an input requires grad) it goes through
``ConvLSTMRecurrence`` — kernel 2 forward, kernel 3 backward, the
counterpart of the JAX package's ``jax.custom_vjp`` — else through
kernel 1, the split JAX makes between the primal and ``_fwd``.  Each
wrapper launches its kernel for CUDA tensors and runs its plain version
only for CPU tensors.

Kernel 1 is reached through the registered operator
``torch.ops.vad_tpu_torch.convlstm_recurrence`` (its CUDA implementation
launches the kernel, its CPU implementation is the plain version, and a
fake implementation gives the output shapes), so ``torch.export`` records
the whole recurrence as one graph node that the saved artifact runs
through the kernel on the card (``utils/export.py``).  The dispatcher picks
the implementation by the tensors' device: a kernel that fails raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vad_tpu_torch.ops import _build
from vad_tpu_torch.ops.weight_cache import WeightCache

State = Tuple[torch.Tensor, torch.Tensor]

_KERNEL = "convlstm_serving"
_BWD_KERNEL = "convlstm_backward"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "convlstm_serving_forward": [_P] * 7 + [_I] * 9 + [_P],
    "convlstm_train_forward": [_P] * 8 + [_I] * 9 + [_P],
    "convlstm_serving_active_clusters": [_I] * 5,
    "convlstm_serving_rows": [_P] * 11 + [_I] * 10,
}
_BWD_SIGNATURES = {
    "convlstm_backward": [_P] * 16 + [_I] * 12 + [_P],
    "convlstm_backward_active_clusters": [_I] * 4,
}
_DESIGN_CODES = {"stepwise": 0, "resident": 1, "stepwise_tc": 2}

NUM_SMS = 132  # H100 SXM
_NT = 64  # wgmma N: GEMM columns of a resident block
_STEP_TILE = (64, 128)  # the stepwise core's output tile (pixels, columns)
_STEP_SMEM = 41_472  # the stepwise core's static shared memory (3-stage ring)
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use (csrc/convlstm_tiles.cuh)
# stepwise_tc (convlstm_tiles.cuh's tile): a warpgroup's 64 x 64 output
# tile, the input channels of a K chunk (all 9 taps: 32 bytes a pixel, 8
# f32 or 16 bf16), and the largest portable cluster that splits K
_TC_TILE, _TC_KC, _TC_KC_BF16, _TC_MAX_CLUSTER = 64, 8, 16, 8
_TC_STAGE_B = 9 * 2 * 64 * _TC_KC * 4  # a stage's f32 B image: 9 taps x 2 planes x 64 rows x 8
_TC_STAGE_B_BF16 = 9 * 64 * _TC_KC_BF16 * 2  # bf16's: 9 taps x 64 rows x 16


def _tc_kc(dtype: torch.dtype) -> int:
    """Input channels of a stepwise_tc K chunk in ``dtype``."""
    return _TC_KC_BF16 if dtype == torch.bfloat16 else _TC_KC


def _tc_stage_b(dtype: torch.dtype) -> int:
    return _TC_STAGE_B_BF16 if dtype == torch.bfloat16 else _TC_STAGE_B


def _tc_smem(warpgroups: int, wid: int, dtype: torch.dtype = torch.float32) -> int:
    """A stepwise_tc block's shared memory (``tc_smem_bytes``): two
    stages of a K chunk's halo rows (64 per warpgroup + 2W + 2, 32 bytes
    padded to 48) and B's stage image (the parked f32 partial tile aliases
    them), and the stages' two mbarriers."""
    halo = _cdiv((64 * warpgroups + 2 * wid + 2) * 12 * 4, 128) * 128
    return max(2 * (halo + _tc_stage_b(dtype)), 64 * warpgroups * 68 * 4) + 16


@dataclass(frozen=True)
class RecurrencePlan:
    """How one call of a recurrence kernel runs on the card.

    ``design`` is ``"resident"``, ``"stepwise_tc"`` or ``"stepwise"``;
    ``grids`` names each launch's grid, ``cluster`` the blocks per cluster
    (1: none; stepwise_tc: the K split of each step), ``smem_bytes`` the
    largest block's shared memory, ``launches`` the launches per call (what
    the kernel's counter adds), ``scratch_bytes`` the device scratch the
    wrapper allocates for the call, ``step_blocks`` the blocks that run one
    step of the recurrence (kernel 3: of its reverse loop), ``warpgroups``
    stepwise_tc's warpgroups a block (its tile is 64 pixels a warpgroup),
    and ``weight_bytes`` stepwise_tc's stage images of Wh (f32: its TF32
    split, ``tf32_split``; bf16: Wh laid out), made once per weight state
    and cached (``_tc_weights``)."""

    kernel: str
    design: str
    launches: int
    cluster: int
    smem_bytes: int
    scratch_bytes: int
    grids: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    gate_groups: int = 0  # kernel 3: the resident gate launch's frame groups, stepwise_tc's cluster
    gate_warpgroups: int = 0  # kernel 3 stepwise_tc: warpgroups a block of the gate launch
    dw_splits: int = 0  # kernel 3: K splits of the dWh launch
    shards: int = 1  # kernel 1's row form: row shards of the frame, one grid each
    step_blocks: int = 0
    warpgroups: int = 0
    weight_bytes: int = 0


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


def tc_fits(ch: int, dtype: torch.dtype, wid: int) -> bool:
    """Whether the stepwise_tc design takes kernels 1-3 (each has the
    design in both types) at this width and type: f32 (its 3xTF32 terms
    keep f32's accuracy) with C % 4 == 0, or bf16 with C % 8 == 0 (a halo
    row's 16-byte pieces hold 4 f32 or 8 bf16 channels; a last K chunk past
    C reads zeros; kernel 3's bf16 dWh stages 8-channel planes); and frame
    rows of ``wid`` pixels whose halo fits a block's shared memory (kernel
    3's bf16 dWh stages at most 64 columns of a row, so its ring fits at any
    width).  Any frame height and batch: pixels beyond the last tile and
    taps outside the frame read zeros."""
    if dtype == torch.float32:
        fits = ch % 4 == 0
    else:
        fits = dtype == torch.bfloat16 and ch % 8 == 0
    return fits and _tc_smem(2, wid, dtype) <= SMEM_LIMIT


def _tc_dw_run(wid: int) -> Tuple[int, int]:
    """Kernel 3's bf16 dWh unit (``tc::dw_tc``): (rows, columns) of one
    frame, the columns ``wid`` rounded up to 16 (a wgmma K step) and at
    most 64, the rows making at most 128 pixels."""
    seg = min(_cdiv(wid, 16) * 16, 64)
    return 128 // seg, seg


def _tc_dw_smem(wid: int, ch: int) -> int:
    """``tc::dw_smem``: three stages of a unit's padded h rows (64 MT input
    channels in 8-channel planes, MT = 2 above C = 64) and its dgates (64
    gate columns), each plane 16 bytes longer than its pixels."""
    rows, seg = _tc_dw_run(wid)
    planes_h = 8 * (2 if ch > 64 else 1)
    stage = planes_h * (rows * (seg + 2) * 16 + 16) + 8 * (rows * seg * 16 + 16)
    return 3 * _cdiv(stage, 128) * 128


def _tc_grid(b: int, hw: int, n_tiles: int, stages: int,
             per_batch: bool = False) -> Tuple[int, int, int]:
    """stepwise_tc's step grid: (warpgroups a block, pixel tiles, cluster
    size) over ``b`` frames of ``hw`` pixels, the tiles raster over the
    batch or (``per_batch``, the row form) within each frame.  Two
    warpgroups (128-pixel tiles: a block's B slice serves both) unless they
    give no fewer tiles than one, or even clusters of 8 would leave SMs
    idle; the K split is the fewest blocks a cluster (a power of two up to
    the portable 8, none with fewer than one K stage) that give at least
    one block per SM."""
    def tiles(nw: int) -> int:
        return b * _cdiv(hw, _TC_TILE * nw) if per_batch else _cdiv(b * hw, _TC_TILE * nw)

    nw = 2 if tiles(2) < tiles(1) and tiles(2) * n_tiles * _TC_MAX_CLUSTER >= NUM_SMS else 1
    m_tiles = tiles(nw)
    ranks = 1
    while (ranks < _TC_MAX_CLUSTER and m_tiles * n_tiles * ranks < NUM_SMS
           and 2 * ranks <= stages):
        ranks *= 2
    return nw, m_tiles, ranks


def _tc_forward_plan(kernel: str, b: int, t: int, hw: int, wid: int, ch: int,
                     dtype: torch.dtype, shards: int = 1) -> RecurrencePlan:
    """Kernels 1-2's stepwise_tc plan (the row form's with ``shards`` > 1:
    ``hw`` is a shard's pixels, tiles within each frame, a launch a shard a
    step)."""
    n_tiles, chunks = _cdiv(ch, 16), _cdiv(ch, _tc_kc(dtype))
    nw, m_tiles, ranks = _tc_grid(b, hw, n_tiles, chunks, per_batch=shards > 1)
    return RecurrencePlan(kernel, "stepwise_tc", launches=t * shards, cluster=ranks,
                          smem_bytes=_tc_smem(nw, wid, dtype), scratch_bytes=0,
                          grids={"step": (ranks, n_tiles, m_tiles)}, shards=shards,
                          step_blocks=ranks * n_tiles * m_tiles, warpgroups=nw,
                          weight_bytes=n_tiles * chunks * _tc_stage_b(dtype))


def recurrence_plan(kernel: str, b: int, t: int, hgt: int, wid: int, ch: int,
                    dtype: torch.dtype, design: Optional[str] = None,
                    shards: int = 1) -> RecurrencePlan:
    """The design, grids, cluster size, shared memory, launches per call
    and scratch of ``kernel`` (``"convlstm_serving"``, ``"convlstm_train_forward"``
    or ``"convlstm_backward"``) at ``gates_x [b, t, hgt, wid, 4*ch]`` of
    ``dtype``.  ``design=None`` takes the resident design wherever it fits,
    else stepwise_tc wherever it fits (``tc_fits``: f32 with C % 4 == 0,
    bf16 with C % 8 == 0), else the stepwise one; naming a design that does
    not fit raises.  The choice depends on the shape and type alone.

    stepwise_tc's step runs on tiles of 64 or 128 pixels (one or two
    warpgroups, ``_tc_grid``) x 64 columns (kernels 1-2: 16 channels x 4
    gates; kernel 3's reverse loop: 64 output channels), and a cluster of up
    to 8 blocks splits each tile's K (chunks of 8 f32 or 16 bf16 channels,
    or of 8 gate columns for kernel 3, at all 9 taps) until the step has at
    least one block per SM (``NUM_SMS``): at C=128,
    256 blocks at the serving shape (S=16, 16x16: 32 x 8 tiles of 128),
    256 for kernel 2 at B=8 (16 x 8 x 2), 256 for kernel 1 at B=1
    (``--video``: 4 x 8 tiles of 64 x 8), 256 for kernel 3's loop at B=8
    (16 x 2 x 8); in bf16 on a 32x32 latent (512x512 frames) 1,024 at S=16
    (128 x 8 tiles of 128), 512 for kernel 2 at B=8, 256 for kernel 1 at
    B=1 (8 x 8 x 4), 256 for kernel 3's loop at B=8 (64 x 2 tiles of 128,
    clusters of 2 over 32 chunks of 16 gate columns).  Kernel 3's other
    launches: the gate recompute on the same tile over all B*T frames; in
    f32 dWh and the last launch (dh0, the split sum of dWh's partials) on
    the stepwise design's mma.sync grids; in bf16 dWh on wgmma, a block a
    tap row x 64 (C <= 64) or 128 input channels x 64 gate columns, its K
    (units of 128 pixels: ``_tc_dw_run``) split to about two blocks an SM,
    and the last launch on the loop's grid with clusters of the split sum
    past its pixel tiles.  Where 8 blocks a tile still fall short the step runs
    on fewer: kernel 3 at B*H*W <= 256 (64 blocks: 4 x 2 tiles x 8; the
    portable cluster holds 8 blocks, and its 64-channel tile halves the
    channel tiles of kernels 1-2) and frames too small for 17 tiles (the
    ragged edge shapes).

    ``shards`` > 1 is kernel 1's row form (``convlstm_recurrence_rows``):
    the ``hgt`` rows split in ``shards`` equal row shards, one launch a
    shard a step (``t * shards`` a call), each on the grid of its own
    ``hgt / shards`` rows; stepwise_tc wherever ``tc_fits`` (its tiles
    then stay within one frame, so a tile's halo holds rows -1 .. Hs of
    its own frame), else stepwise.  The resident design cannot take it: a
    resident cluster keeps h in its shared memory and cannot see a
    neighbour shard's rows."""
    if kernel not in _KERNELS:
        raise ValueError(f"unknown recurrence kernel {kernel!r}")
    if design is not None and design not in _DESIGN_CODES:
        raise ValueError(f"unknown design {design!r}")
    if shards > 1:
        if kernel != "convlstm_serving":
            raise ValueError(f"only kernel 1 has a row form, not {kernel}")
        if hgt % shards:
            raise ValueError(f"{hgt} rows do not split in {shards} equal shards")
        if design == "resident":
            raise ValueError("the row form is stepwise_tc or stepwise: the resident design keeps "
                             "h in one cluster's shared memory and cannot see a neighbour shard")
        rows = hgt // shards
        if design is None:
            design = "stepwise_tc" if tc_fits(ch, dtype, wid) else "stepwise"
        elif design == "stepwise_tc" and not tc_fits(ch, dtype, wid):
            raise ValueError(f"the stepwise_tc design does not take the row form at "
                             f"B={b} T={t} {rows}x{wid} C={ch} {dtype}")
        if design == "stepwise_tc":
            return _tc_forward_plan(kernel, b, t, rows * wid, wid, ch, dtype, shards)
        step = (_cdiv(b * rows * wid, _STEP_TILE[0]), _cdiv(ch, 32))
        return RecurrencePlan(kernel, "stepwise", launches=t * shards, cluster=1,
                              smem_bytes=_STEP_SMEM, scratch_bytes=0, grids={"step": step},
                              shards=shards, step_blocks=step[0] * step[1])
    fits = {"resident": resident_fits(kernel, hgt, wid, ch, dtype),
            "stepwise_tc": tc_fits(ch, dtype, wid), "stepwise": True}
    if design is None:
        design = next(d for d in ("resident", "stepwise_tc", "stepwise") if fits[d])
    elif not fits[design]:
        raise ValueError(f"the {design} design does not take {kernel} at "
                         f"B={b} T={t} {hgt}x{wid} C={ch} {dtype}")
    hw, four_c = hgt * wid, 4 * ch
    act_bytes = b * t * hw * four_c * 4  # kernel 3's f32 gate activations
    if kernel != "convlstm_backward":
        if design == "resident":
            return RecurrencePlan(kernel, design, launches=1, cluster=ch // 16,
                                  smem_bytes=_resident_smem(kernel, hgt, wid, ch),
                                  scratch_bytes=0, grids={"recurrence": (ch // 16, b)},
                                  step_blocks=ch // 16 * b)
        if design == "stepwise_tc":
            return _tc_forward_plan(kernel, b, t, hw, wid, ch, dtype)
        step = (_cdiv(b * hw, _STEP_TILE[0]), _cdiv(ch, 32))
        return RecurrencePlan(kernel, design, launches=t, cluster=1, smem_bytes=_STEP_SMEM,
                              scratch_bytes=0, grids={"step": step},
                              step_blocks=step[0] * step[1])
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
            gate_groups=gate_groups, dw_splits=splits, step_blocks=blocks * b)
    step = (_cdiv(b * hw, _STEP_TILE[0]), _cdiv(ch, _STEP_TILE[1]))
    dw_tiles = (_cdiv(9 * ch, 64), _cdiv(four_c, _STEP_TILE[1]))
    stages = _cdiv(b * t * hw, 64 // (2 if dtype == torch.bfloat16 else 4))  # 64-byte K stages
    splits = _even_splits(stages, 2 * NUM_SMS // (dw_tiles[0] * dw_tiles[1]))
    grids = {"gate": (_cdiv(b * t * hw, _STEP_TILE[0]), _cdiv(ch, 32)), "step": step,
             "dw": dw_tiles + (splits,),
             "finish": (step[0] * step[1] + _cdiv(9 * ch * four_c, 256),)}
    scratch = act_bytes + splits * 9 * ch * four_c * 4
    if design == "stepwise_tc":  # the gate recompute and the reverse loop on the tile
        n_tiles, kc = _cdiv(ch, _TC_TILE), _tc_kc(dtype)
        nw, m_tiles, ranks = _tc_grid(b, hw, n_tiles, four_c // kc)
        g_nw, g_tiles, g_ranks = _tc_grid(b * t, hw, _cdiv(ch, 16), _cdiv(ch, kc))
        grids.update(step=(ranks, n_tiles, m_tiles), gate=(g_ranks, _cdiv(ch, 16), g_tiles))
        smem = max(_tc_smem(max(nw, g_nw), wid, dtype), _STEP_SMEM)
        if dtype == torch.bfloat16:  # dWh on bf16 wgmma, dh0 + the split sum on the tile
            rows, seg = _tc_dw_run(wid)
            units = b * t * _cdiv(hgt, rows) * _cdiv(wid, seg)
            dw_blocks = 3 * _cdiv(ch, 128 if ch > 64 else 64) * _cdiv(four_c, 64)
            splits = _even_splits(units, 2 * NUM_SMS // dw_blocks)
            planes = _cdiv(9 * ch * four_c, 8 * ranks * n_tiles * nw * 128)
            grids.update(dw=(dw_blocks, splits), finish=(ranks, n_tiles, m_tiles + planes))
            scratch = act_bytes + splits * 9 * ch * four_c * 4
            smem = max(_tc_smem(max(nw, g_nw), wid, dtype), _tc_dw_smem(wid, ch))
        return RecurrencePlan(kernel, design, launches=t + 3, cluster=ranks,
                              smem_bytes=smem, scratch_bytes=scratch, grids=grids,
                              gate_groups=g_ranks, gate_warpgroups=g_nw, dw_splits=splits,
                              step_blocks=ranks * n_tiles * m_tiles, warpgroups=nw,
                              weight_bytes=(n_tiles * four_c // kc + _cdiv(ch, 16)
                                            * _cdiv(ch, kc)) * _tc_stage_b(dtype))
    return RecurrencePlan(kernel, design, launches=t + 3, cluster=1, smem_bytes=_STEP_SMEM,
                          scratch_bytes=scratch, grids=grids, dw_splits=splits,
                          step_blocks=step[0] * step[1])


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
    return _lstm_update(gates_x_t + conv.permute(0, 2, 3, 1), c)


def _lstm_update(gates: torch.Tensor, c: torch.Tensor) -> State:
    """The gate math in the carry's type: ``(h, c)`` of the next step."""
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


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest, ties away from zero, on the 13 low mantissa bits, which come
    out zero (adding half of the dropped range to the sign-magnitude bits
    carries into the kept ones exactly when the dropped bits reach half)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> torch.Tensor:
    """``[2, *x.shape]``: x's TF32 big term ``rna(x)`` and small term
    ``rna(x - big)`` (``x - big`` is exact in f32), the 3xTF32 operand
    split of the stepwise_tc design; ``big + small`` is x to about 2^-22."""
    big = tf32_rna(x.float())
    return torch.stack([big, tf32_rna(x.float() - big)])


def tc_weight_layout(w_h: torch.Tensor, layout: str, kc: int = _TC_KC) -> torch.Tensor:
    """``w_h`` as stepwise_tc's B rows: ``[column tiles, K chunks, 9 taps,
    64 rows, kc]``, row n of a tile holding its ``kc`` values of the chunk
    (zeros past C).  ``"fwd"`` (kernels 1-2): tiles of 16 hidden channels,
    row n = gate n / 16 of channel 16 tile + n % 16 (Wh column gate * C +
    channel), chunks of ``kc`` input channels (8 in f32, 16 in bf16);
    ``"bwd"`` (kernel 3's dh product): tiles of 64 output channels, row n =
    channel 64 tile + n, chunks of ``kc`` of the 4C gate columns."""
    ch = w_h.shape[2]
    w9 = w_h.reshape(9, ch, 4 * ch)
    if layout == "fwd":  # [9, C (K), 4, C (rows)] -> [tiles, chunks, 9, 4, 16, kc]
        w = F.pad(w9.reshape(9, ch, 4, ch), (0, -ch % 16, 0, 0, 0, -ch % kc))
        w = w.reshape(9, -1, kc, 4, w.shape[-1] // 16, 16)
        return w.permute(4, 1, 0, 3, 5, 2).reshape(w.shape[4], w.shape[1], 9, 64, kc)
    w = F.pad(w9, (0, 0, 0, -ch % 64))  # [9, C (rows), 4C (K)]
    w = w.reshape(9, -1, 64, 4 * ch // kc, kc)
    return w.permute(1, 3, 0, 2, 4)


def tc_stage_images(w_h: torch.Tensor, layout: str) -> torch.Tensor:
    """stepwise_tc's B operand as the kernels' shared-memory stage images
    (``convlstm_tiles.cuh``), each stage one contiguous copy.  f32: the
    TF32 terms of ``w_h``, ``[column tiles, K chunks, 9 taps, 2 planes (big,
    small), 2 groups of 4, 64 rows, 4]``; bf16 (either layout): ``w_h``
    itself, no split, ``[column tiles, K chunks of 16, 9 taps, 2 groups of
    8, 64 rows, 8]``."""
    if w_h.dtype == torch.bfloat16:
        rows = tc_weight_layout(w_h, layout, _TC_KC_BF16)  # [tiles, chunks, 9, 64, 16]
        rows = rows.reshape(*rows.shape[:4], 2, 8)  # the 16 of K in two groups of 8
        return rows.permute(0, 1, 2, 4, 3, 5).contiguous()
    rows = tc_weight_layout(w_h, layout)  # [tiles, chunks, 9, 64, 8]
    split = tf32_split(rows)  # [2, tiles, chunks, 9, 64, 8]
    split = split.reshape(*split.shape[:5], 2, 4)  # the 8 of K in two groups of 4
    return split.permute(1, 2, 3, 0, 5, 4, 6).contiguous()


def _stage_images_on(w_h: torch.Tensor, layout: str, device: torch.device) -> torch.Tensor:
    return tc_stage_images(w_h, layout).to(device)


# ``tc_stage_images`` of a weight tensor, per layout and device, made once
# per weight state (``ops/weight_cache.py``): Wh is constant over a call's T
# steps, and a model's weights over many calls
_tc_images = WeightCache(_stage_images_on)


def _tc_weights(w_h: torch.Tensor, layout: str,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """``tc_stage_images(w_h, layout)`` on ``device`` (``w_h``'s own when
    None), cached per weight tensor, state, layout and device
    (``WeightCache``: what it sees and what needs ``drop_weight_caches``)."""
    return _tc_images(w_h, layout, torch.device(device) if device is not None else w_h.device)


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
    if plan.design == "resident":
        w_t = _w_t(w)
    elif plan.design == "stepwise_tc":
        w_t = _tc_weights(w, "fwd")
    else:
        w_t = w
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
                 _DESIGN_CODES[plan.design], plan.cluster, plan.warpgroups, stream)
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
    (1 resident, T stepwise_tc or stepwise), counted in
    ``convlstm_train_forward.launches``."""
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
    tc = plan.design == "stepwise_tc"  # its stage images of Wh, else unread
    w_tc, w_tc_fwd = (_tc_weights(w, "bwd"), _tc_weights(w, "fwd")) if tc else (w_t, w_t)
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
            part.data_ptr(), w_tc.data_ptr(), w_tc_fwd.data_ptr(),
            b, t, hgt, wid, ch, int(dt == torch.bfloat16), _DESIGN_CODES[plan.design],
            plan.gate_groups, plan.dw_splits, plan.cluster, plan.warpgroups,
            plan.gate_warpgroups, stream,
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
    says (4 resident, T + 3 stepwise_tc or stepwise), counted in
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


@torch.library.custom_op("vad_tpu_torch::convlstm_recurrence", mutates_args=(),
                         device_types="cpu")
def _recurrence_op(gates_x: torch.Tensor, w_h: torch.Tensor, h0: torch.Tensor,
                   c0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(h_seq, h_T, c_T)``: the plain version on the CPU."""
    h_seq, (hf, cf) = convlstm_recurrence_ref(gates_x, w_h, h0, c0)
    return h_seq, hf, cf


@_recurrence_op.register_kernel("cuda")
def _recurrence_op_cuda(gates_x, w_h, h0, c0):
    """Kernel 1 on the card, in the design ``recurrence_plan`` picks at run
    time from the call's shapes."""
    h_seq, _, (hf, cf) = _forward_kernel(gates_x, w_h, h0, c0, with_cell_seq=False)
    return h_seq, hf, cf


@_recurrence_op.register_fake
def _recurrence_op_fake(gates_x, w_h, h0, c0):
    """Output shapes and types: ``h_seq [B,T,H,W,C]`` in the gates' type,
    the finals ``[B,H,W,C]`` in f32."""
    b, t, hgt, wid, four_c = gates_x.shape
    seq = gates_x.new_empty((b, t, hgt, wid, four_c // 4))
    final = gates_x.new_empty((b, hgt, wid, four_c // 4), dtype=torch.float32)
    return seq, final, torch.empty_like(final)


def convlstm_recurrence(
    gates_x: torch.Tensor, w_h: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
    remat: bool = False,
) -> Tuple[torch.Tensor, State]:
    """The recurrence; same contract as ``convlstm_recurrence_ref``.

    Under autograd (grad enabled, an input requiring grad) it runs
    ``ConvLSTMRecurrence``: kernels 2 and 3 on the card.  Otherwise the
    operator ``torch.ops.vad_tpu_torch.convlstm_recurrence``: kernel 1 on
    the card (launches per call as ``recurrence_plan`` says, counted in
    ``convlstm_recurrence.launches``), or the plain version for CPU
    tensors.  ``remat`` is accepted and does nothing here, as on the JAX
    package's Pallas path: the backward already recomputes the gates."""
    del remat
    if gates_x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"convlstm_recurrence: unsupported device {gates_x.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (gates_x, w_h, h0, c0)):
        h_seq, hf, cf = ConvLSTMRecurrence.apply(gates_x, w_h, h0, c0)
        return h_seq, (hf, cf)
    h_seq, hf, cf = _recurrence_op(gates_x, w_h, h0, c0)
    return h_seq, (hf, cf)


# ---------------------------------------------------- kernel 1's row form


def _shard_weights(w_h, gates_x_rows) -> List[torch.Tensor]:
    """``w_h`` (one tensor, or one per shard) for each shard, where it is."""
    if isinstance(w_h, torch.Tensor):
        return [w_h] * len(gates_x_rows)
    if len(w_h) != len(gates_x_rows):
        raise ValueError(f"{len(w_h)} w_h for {len(gates_x_rows)} shards")
    return list(w_h)


def _weights_per_shard(w_h, gates_x_rows) -> List[torch.Tensor]:
    """``w_h`` (one tensor, or one per shard) on each shard's device."""
    return [w.to(x.device) for w, x in zip(_shard_weights(w_h, gates_x_rows), gates_x_rows)]


def convlstm_recurrence_rows_ref(
    gates_x_rows: Sequence[torch.Tensor], w_h,
    h0_rows: Sequence[torch.Tensor], c0_rows: Sequence[torch.Tensor],
) -> Tuple[List[torch.Tensor], List[State]]:
    """Plain version of kernel 1's row form: the recurrence of a frame split
    in row shards, shard i holding ``gates_x_rows[i] [B,T,Hs,W,4C]`` and
    ``h0_rows[i], c0_rows[i] [B,Hs,W,C]`` on its own device; ``w_h`` is one
    ``[3,3,C,4C]`` tensor or one per shard (each shard's model copy).

    Every shard steps in lockstep: at step t it takes its neighbours'
    boundary rows of h_{t-1} (zeros at the frame's top and bottom), copied
    to its device, concatenates them above and below its own rows and runs
    the hidden conv with ``padding=(0, 1)``; the gate math is
    ``convlstm_step``'s.  Returns ``(h_seq per shard [B,T,Hs,W,C] in the
    gates' type, (h_T, c_T) per shard in f32)``: the unsplit recurrence's
    rows."""
    n = len(gates_x_rows)
    w_oihw = [w.permute(3, 2, 0, 1) for w in _weights_per_shard(w_h, gates_x_rows)]
    hs = [h.float() for h in h0_rows]
    cs = [c.float() for c in c0_rows]
    seqs: List[List[torch.Tensor]] = [[] for _ in range(n)]
    for t in range(gates_x_rows[0].shape[1]):
        prev = [h.to(w.dtype) for h, w in zip(hs, w_oihw)]  # as convlstm_step casts it
        for i, gx in enumerate(gates_x_rows):
            edge = torch.zeros_like(prev[i][:, :1])
            top = prev[i - 1][:, -1:].to(gx.device) if i > 0 else edge
            bot = prev[i + 1][:, :1].to(gx.device) if i < n - 1 else edge
            rows = torch.cat([top, prev[i], bot], dim=1).permute(0, 3, 1, 2)
            conv = F.conv2d(rows, w_oihw[i], padding=(0, 1))
            hs[i], cs[i] = _lstm_update(gx[:, t] + conv.permute(0, 2, 3, 1), cs[i])
            seqs[i].append(hs[i].to(gx.dtype))
    return [torch.stack(s, dim=1) for s in seqs], list(zip(hs, cs))


def convlstm_recurrence_rows(
    gates_x_rows: Sequence[torch.Tensor], w_h,
    h0_rows: Sequence[torch.Tensor], c0_rows: Sequence[torch.Tensor],
    staged: bool = False, design: Optional[str] = None,
) -> Tuple[List[torch.Tensor], List[State]]:
    """Kernel 1's row form; same contract as ``convlstm_recurrence_rows_ref``
    (inference only: nothing is recorded for autograd).

    On the card (every shard a CUDA tensor) one call of
    ``csrc/convlstm_serving.cu``'s ``convlstm_serving_rows``: in the design
    of ``recurrence_plan(..., shards=n)`` (stepwise_tc wherever it fits,
    else stepwise; ``design`` names one, and naming one that does not fit
    raises), ``T * shards`` launches, counted in
    ``convlstm_recurrence.launches``; a failed launch raises.  stepwise_tc's
    stage images of Wh are cached per weight tensor and shard device
    (``_tc_weights``), not made per call.
    Shard i runs on its device's current stream; a neighbour on the same
    device and stream is read in place, any other through a ``[B,W,C]``
    staging copy ordered by an event.  ``staged`` gives every shard a stream
    of its own, so even shards on one card take the staging path (a check
    of that path on one card).  CPU tensors run the plain version."""
    devices = {x.device.type for x in (*gates_x_rows, *h0_rows, *c0_rows)}
    if devices == {"cpu"}:
        return convlstm_recurrence_rows_ref(gates_x_rows, w_h, h0_rows, c0_rows)
    if devices != {"cuda"}:
        raise ValueError(f"convlstm_recurrence_rows: shards on {sorted(devices)}")
    return _rows_kernel(gates_x_rows, w_h, h0_rows, c0_rows, staged, design)


@torch.no_grad()
def _rows_kernel(gates_x_rows, w_h, h0_rows, c0_rows, staged: bool, design: Optional[str]):
    n = len(gates_x_rows)
    if not (n == len(h0_rows) == len(c0_rows)) or n < 1:
        raise ValueError(f"{n} gates_x, {len(h0_rows)} h0 and {len(c0_rows)} c0 shards")
    weights = [w.contiguous() for w in _weights_per_shard(w_h, gates_x_rows)]
    shape, dt = gates_x_rows[0].shape, gates_x_rows[0].dtype
    for gx, w, h0, c0 in zip(gates_x_rows, weights, h0_rows, c0_rows):
        if gx.shape != shape or gx.dtype != dt:
            raise ValueError(f"row shards differ: {tuple(gx.shape)} {gx.dtype} against "
                             f"{tuple(shape)} {dt}")
        _validate("convlstm_serving_rows", gx, w, h0, c0)
    b, t, rows, wid, four_c = shape
    ch = four_c // 4
    plan = recurrence_plan("convlstm_serving", b, t, rows * n, wid, ch, dt, design, shards=n)
    # stepwise_tc's stage images on each shard's device (else unread: Wh)
    w_t = ([_tc_weights(w, "fwd", x.device)
            for w, x in zip(_shard_weights(w_h, gates_x_rows), gates_x_rows)]
           if plan.design == "stepwise_tc" else weights)
    seq_shape = (b, t, rows, wid, ch)
    gx = [x.contiguous() for x in gates_x_rows]
    h0_in = [h.to(dt).contiguous() for h in h0_rows]  # the conv's input at t = 0
    c = [x.to(torch.float32, copy=True).contiguous() for x in c0_rows]  # updated in place
    h_final = [torch.empty(h.shape, dtype=torch.float32, device=h.device) for h in h0_in]
    h_seq = [torch.empty(seq_shape, dtype=dt, device=x.device) for x in gx]

    def stage(i: int, j: int):
        """Shard i's buffer for neighbour j's row, or None to read it in place
        (the same device, so the same stream, unless ``staged``)."""
        if not 0 <= j < n or (gx[j].device == gx[i].device and not staged):
            return None
        return torch.empty((b, wid, ch), dtype=dt, device=gx[i].device)

    top = [stage(i, i - 1) for i in range(n)]
    bot = [stage(i, i + 1) for i in range(n)]
    streams = []
    for x in gx:
        current = torch.cuda.current_stream(x.device)
        if staged:  # after the copies and buffers above: a side stream starts behind them
            side = torch.cuda.Stream(x.device)
            side.wait_stream(current)
            streams.append(side)
        else:
            streams.append(current)

    def ptrs(tensors) -> ctypes.Array:
        return (ctypes.c_void_p * n)(*[0 if x is None else x.data_ptr() for x in tensors])

    lib = _build.load(_KERNEL, _SIGNATURES)
    status = lib.convlstm_serving_rows(
        ptrs(gx), ptrs(weights), ptrs(w_t), ptrs(h0_in), ptrs(c), ptrs(h_seq),
        ptrs(h_final), ptrs(top), ptrs(bot),
        (ctypes.c_int * n)(*[x.device.index for x in gx]),
        (ctypes.c_void_p * n)(*[s.cuda_stream for s in streams]),
        n, b, t, rows, wid, ch, int(dt == torch.bfloat16), _DESIGN_CODES[plan.design],
        plan.cluster, plan.warpgroups)
    if staged:
        for x, side in zip(gx, streams):
            torch.cuda.current_stream(x.device).wait_stream(side)
    _build.check(lib, _KERNEL, status)
    convlstm_recurrence.launches += plan.launches
    return h_seq, list(zip(h_final, c))


convlstm_recurrence.launches = 0
convlstm_train_forward.launches = 0
convlstm_backward.launches = 0
