"""The frozen counts of work against counts made by hand."""

import pytest

from benchmark import counts


def test_model_flops_per_frame_by_hand():
    # encoder convs at 256^2, 128^2, 64^2, 32^2 (each before its pool)
    enc = (65536 * 3 * 32 + 16384 * 32 * 64 + 4096 * 64 * 128 + 1024 * 128 * 128) * 9 * 2
    lstm = 2 * 2 * 256 * 128 * 9 * 512 * 2  # 2 layers x (input + hidden conv) at 16x16
    dec = (256 * 128 * 128 + 1024 * 128 * 64 + 4096 * 64 * 32 + 16384 * 32 * 3) * 4 * 2
    assert counts.model_flops_per_frame(256) == enc + lstm + dec
    assert counts.model_flops_per_frame(256) == pytest.approx(3.0115e9, rel=1e-4)
    assert counts.model_flops_per_frame(512) == 4 * counts.model_flops_per_frame(256)


def test_recurrence_forward_by_hand():
    flops, nbytes = counts.recurrence_forward(16, 16, 16, 16, 128, 2)
    assert flops == 16 * 16 * 256 * (128 * 9) * 512 * 2
    gates, h_seq = 16 * 16 * 256 * 512 * 2, 16 * 16 * 256 * 128 * 2
    states, w_h = 4 * 16 * 256 * 128 * 4, 9 * 128 * 512 * 2
    assert nbytes == gates + h_seq + states + w_h
    _, with_cell = counts.recurrence_forward(16, 16, 16, 16, 128, 2, cell=True)
    assert with_cell == nbytes + h_seq


def test_recurrence_backward_by_hand():
    flops, nbytes = counts.recurrence_backward(8, 16, 16, 16, 128, 4)
    seq = 8 * 16 * 256 * 128
    assert flops == 3 * seq * (9 * 512) * 2  # gate recompute, dh, dWh
    reads = seq * 4 * 4 + 3 * seq * 4 + 9 * 128 * 512 * 4 + 4 * 8 * 256 * 128 * 4
    writes = seq * 4 * 4 + 9 * 128 * 512 * 4 + 2 * 8 * 256 * 128 * 4
    # gates_x, h_seq, c_seq, dh_seq, W_h, h0, c0, dh_T, dc_T; dgates_x, dW_h, dh0, dc0
    assert nbytes == reads + writes


def test_first_block_by_hand():
    flops, nbytes = counts.first_block(256, 256, 256, 2)
    assert flops == 256 * 65536 * 32 * 27 * 2
    assert nbytes == 256 * 65536 * 3 + 256 * 16384 * 32 * 2 + (32 * 27 + 32) * 4


def test_bound_takes_the_larger_side():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)
