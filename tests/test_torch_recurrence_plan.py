"""The recurrence kernels' plan (``vad_tpu_torch.ops.convlstm.recurrence_plan``).

The plan picks, from (B, T, H, W, C, dtype) alone, the design each of
kernels 1-3 runs in on the card, and states its grids, cluster size, shared
memory, launches per call and scratch.  The kernels themselves run only on
the card (chip_smoke.py holds every design against the plain versions
there); these tests hold the plan to the kernels' limits and check that the
CPU wrappers, which run the plain versions, count no launch.
"""

import numpy as np
import pytest
import torch

from vad_tpu_torch.ops import convlstm
from vad_tpu_torch.ops.convlstm import recurrence_plan, resident_fits

KERNELS = ("convlstm_serving", "convlstm_train_forward", "convlstm_backward")
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on an H100
BF16, F32 = torch.bfloat16, torch.float32

SERVING = (16, 16, 16, 16, 128)  # S=16 streams, T=16, 256x256 frames -> 16x16 latent
TRAINING = (8, 16, 16, 16, 128)  # B=8 windows of T=16
EDGE = ((3, 3, 5, 7, 48), (2, 4, 3, 9, 20), (3, 2, 8, 8, 32), (2, 3, 8, 16, 64))
IMAGE_512 = (8, 16, 32, 32, 128)  # a 512x512 image: a 32x32 latent frame


def plane(h, w):
    """Bytes of one padded 8-channel plane, rounded to TMA's 128."""
    return -(-(h + 2) * (w + 2) * 16 // 128) * 128


def resident_bytes(kernel, h, w, c):
    """The resident blocks' shared memory, written out from the kernels'
    layouts: C/8 planes of the padded frame, 9C x 64 bf16 of Wh and an
    mbarrier; kernel 3's loop also holds 64 f32 dgates a pixel, its dWh
    8 x 16 bytes a pixel."""
    frame, wh = c // 8 * plane(h, w), 9 * c * 64 * 2
    if kernel != "convlstm_backward":
        return frame + wh + 16
    return max(frame + wh + 16, max(frame, h * w * 256) + wh, frame + h * w * 128 + 16)


def expected_design(kernel, shape, dtype):
    _, _, h, w, c = shape
    tiles_ok = h % 8 == 0 and w % 8 == 0 and (h // 8) * (w // 8) <= 4
    fits = dtype == BF16 and tiles_ok and c % 16 == 0 and c <= 128
    if kernel == "convlstm_backward":
        fits = fits and w % 16 == 0 and c % 64 == 0
    fits = fits and resident_bytes(kernel, h, w, c) <= SMEM_LIMIT
    return "resident" if fits else "stepwise"


# Frames of four 8x8 tiles in a row: at C=128 the resident blocks need
# 16 x 5,504 + 147,456 + 16 = 235,536 bytes, over the limit; at C=112,
# 14 x 5,504 + 129,024 + 16 = 206,096.
WIDE_128, TALL_128 = (2, 3, 8, 32, 128), (2, 3, 32, 8, 128)
WIDE_112, TALL_112 = (2, 3, 8, 32, 112), (2, 3, 32, 8, 112)
ALL_SHAPES = (SERVING, TRAINING, *EDGE, IMAGE_512, WIDE_128, TALL_128, WIDE_112, TALL_112)


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", (BF16, F32), ids=("bf16", "f32"))
@pytest.mark.parametrize("kernel", KERNELS)
def test_plan_design_and_limits(kernel, dtype, shape):
    b, t, h, w, c = shape
    plan = recurrence_plan(kernel, b, t, h, w, c, dtype)
    assert plan.design == expected_design(kernel, shape, dtype)
    assert resident_fits(kernel, h, w, c, dtype) == (plan.design == "resident")
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.launches >= 1 and plan.scratch_bytes >= 0
    if plan.design == "resident":
        blocks = c // 16  # 16 hidden channels (x 4 gates = 64 columns) a block
        assert plan.cluster <= 8 and blocks % plan.cluster == 0
        wh_slice = 9 * c * 64 * 2
        assert plan.smem_bytes >= c // 8 * plane(h, w) + wh_slice
    else:
        assert plan.cluster == 1


@pytest.mark.parametrize("kernel,shape", [("convlstm_serving", SERVING),
                                          ("convlstm_train_forward", TRAINING)])
def test_forward_plans_at_slice_shapes(kernel, shape):
    b, t, h, w, c = shape
    res = recurrence_plan(kernel, b, t, h, w, c, BF16)
    assert (res.design, res.launches, res.cluster) == ("resident", 1, 8)
    assert res.grids == {"recurrence": (8, b)}  # one cluster of 8 per batch element
    # 16 planes of 18x18 padded pixels + 9C x 64 of Wh + an mbarrier
    assert res.smem_bytes == 16 * 5248 + 147_456 + 16 == 231_440
    assert res.scratch_bytes == 0
    for dtype in (BF16, F32):
        step = recurrence_plan(kernel, b, t, h, w, c, dtype, design="stepwise")
        assert (step.design, step.launches, step.cluster) == ("stepwise", t, 1)
        assert step.grids == {"step": (b * h * w // 64, c // 32)}


def test_backward_plan_at_training_shape():
    b, t, h, w, c = TRAINING
    res = recurrence_plan("convlstm_backward", b, t, h, w, c, BF16)
    assert (res.design, res.launches, res.cluster) == ("resident", 4, 8)
    assert res.launches <= t + 3
    assert res.grids["loop"] == (8, b)
    gate_blocks = res.grids["gate"][0] * res.grids["gate"][1]
    dw_blocks = res.grids["dw"][0] * res.grids["dw"][1]
    assert gate_blocks <= 132 and dw_blocks >= 132  # one wave; >= one block per SM
    assert res.grids["dw"] == (24, res.dw_splits)  # 3 tap rows x 8 column tiles
    act = b * t * h * w * 4 * c * 4
    assert act == 67_108_864  # the f32 gate activations, 67 MB
    assert res.scratch_bytes == act + res.dw_splits * 9 * c * 4 * c * 4
    step = recurrence_plan("convlstm_backward", b, t, h, w, c, F32)
    assert (step.design, step.launches) == ("stepwise", t + 3)
    assert step.dw_splits == 3  # 18 x 4 output tiles x 3 = 216 blocks, two a SM
    assert step.scratch_bytes == act + 3 * 9 * c * 4 * c * 4
    assert step.grids["step"] == (b * h * w // 64, 1) and step.grids["dw"] == (18, 4, 3)
    # dh0's 32 tiles, then one thread a dWh element for the split sum
    assert step.grids["finish"] == (32 + 9 * c * 4 * c // 256,)


@pytest.mark.parametrize("shape", ALL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_plan_covers_every_frame(shape):
    b, t, h, w, c = shape
    for dtype in (BF16, F32):
        plan = recurrence_plan("convlstm_backward", b, t, h, w, c, dtype)
        assert plan.launches <= t + 3
        # every K split has work: frames (resident) or 64-byte stages of pixels
        units = b * t if plan.design == "resident" else -(-b * t * h * w * dtype.itemsize // 64)
        splits = plan.dw_splits
        per = -(-units // splits)
        assert 1 <= splits <= units and (splits - 1) * per < units
        if plan.design == "resident":
            assert 1 <= plan.gate_groups <= b * t


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("shape", (EDGE[0], EDGE[1], IMAGE_512), ids=("5x7", "3x9", "32x32"))
def test_naming_a_design_that_does_not_fit_raises(kernel, shape):
    b, t, h, w, c = shape
    with pytest.raises(ValueError, match="does not take"):
        recurrence_plan(kernel, b, t, h, w, c, BF16, design="resident")
    with pytest.raises(ValueError, match="does not take"):
        recurrence_plan(kernel, *TRAINING, F32, design="resident")


def test_unknown_kernel_or_design_raises():
    with pytest.raises(ValueError, match="unknown recurrence kernel"):
        recurrence_plan("convlstm", *TRAINING, BF16)
    with pytest.raises(ValueError, match="unknown design"):
        recurrence_plan("convlstm_backward", *TRAINING, BF16, design="fused")


@pytest.mark.parametrize("shape", (WIDE_128, TALL_128), ids=("8x32", "32x8"))
@pytest.mark.parametrize("kernel", KERNELS)
def test_resident_plan_over_the_shared_memory_limit_goes_stepwise(kernel, shape):
    """Four 8x8 tiles pass the tile rule, but C=128's planes and Wh slice
    need 235,536 bytes a block: every kernel takes the stepwise design,
    and naming the resident one raises."""
    b, t, h, w, c = shape
    assert resident_bytes(kernel, h, w, c) >= 235_520 > SMEM_LIMIT
    plan = recurrence_plan(kernel, b, t, h, w, c, BF16)
    assert plan.design == "stepwise" and plan.smem_bytes <= SMEM_LIMIT
    assert not resident_fits(kernel, h, w, c, BF16)
    with pytest.raises(ValueError, match="does not take"):
        recurrence_plan(kernel, b, t, h, w, c, BF16, design="resident")


@pytest.mark.parametrize("shape", (WIDE_112, TALL_112), ids=("8x32", "32x8"))
@pytest.mark.parametrize("kernel", KERNELS[:2])
def test_resident_plan_just_under_the_limit(kernel, shape):
    """C=112 on the same frames fits (206,096 bytes): kernels 1-2 stay
    resident, in clusters of 7."""
    b, t, h, w, c = shape
    plan = recurrence_plan(kernel, b, t, h, w, c, BF16)
    assert (plan.design, plan.cluster) == ("resident", 7)
    assert plan.smem_bytes == 14 * 5504 + 129_024 + 16 == 206_096


def test_edge_plans_mix_designs():
    """C=32 on 8x8: kernels 1-2 resident in clusters of 2, kernel 3 stepwise
    (its dh product takes 64 output channels a block); C=64 on 8x16: all
    resident in clusters of 4."""
    small, wide = EDGE[2], EDGE[3]
    assert recurrence_plan("convlstm_serving", *small, BF16).cluster == 2
    assert recurrence_plan("convlstm_backward", *small, BF16).design == "stepwise"
    for kernel in KERNELS:
        plan = recurrence_plan(kernel, *wide, BF16)
        assert (plan.design, plan.cluster) == ("resident", 4)


@pytest.mark.parametrize("shape", ((2, 3, 16, 16, 128), EDGE[3], EDGE[0]),
                         ids=("16x16", "8x16", "5x7"))
@pytest.mark.parametrize("dtype", (BF16, F32), ids=("bf16", "f32"))
def test_cpu_wrappers_count_no_launch(shape, dtype):
    b, t, h, w, c = shape
    rng = np.random.default_rng(0)
    gx = torch.from_numpy(rng.normal(size=(b, t, h, w, 4 * c)).astype(np.float32) * 0.5)
    wh = torch.from_numpy(rng.normal(size=(3, 3, c, 4 * c)).astype(np.float32) * 0.05)
    h0 = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32) * 0.1)
    gx, wh = gx.to(dtype), wh.to(dtype)
    counters = (convlstm.convlstm_recurrence, convlstm.convlstm_train_forward,
                convlstm.convlstm_backward)
    before = [f.launches for f in counters]
    with torch.no_grad():
        seq, _ = convlstm.convlstm_recurrence(gx, wh, h0, h0)
    leaves = [x.clone().requires_grad_() for x in (gx, wh, h0, h0)]
    seq2, (hf, cf) = convlstm.convlstm_recurrence(*leaves)
    (seq2.float().sum() + hf.sum() + cf.sum()).backward()
    assert [f.launches for f in counters] == before
    torch.testing.assert_close(seq, seq2.detach())
    assert all(x.grad is not None for x in leaves)
