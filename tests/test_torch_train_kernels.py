"""The port's training recurrence (kernels 2 and 3) against the JAX package's.

On the CPU the wrappers run their plain PyTorch versions
(``convlstm_forward_ref``, ``convlstm_backward_ref``); the CUDA kernels run
only on the card, where chip_smoke.py holds them against these same plain
versions.  The JAX side runs ``_run_forward`` and the custom VJP of
``convlstm_recurrence_pallas`` with its Pallas kernels in interpreter mode.
Inputs come from a numpy seed.

Bar: f32 rtol 1e-4 / atol 1e-5 (tests/test_pallas_convlstm.py's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vad_tpu.ops import convlstm_pallas
from vad_tpu.ops.convlstm_pallas import convlstm_recurrence_pallas
from vad_tpu_torch.ops import convlstm as convlstm_ops
from vad_tpu_torch.ops import encoder_fused
from vad_tpu_torch.ops.convlstm import (
    ConvLSTMRecurrence,
    convlstm_backward,
    convlstm_backward_ref,
    convlstm_forward_ref,
    convlstm_recurrence,
    convlstm_recurrence_ref,
    convlstm_train_forward,
)

F32 = dict(rtol=1e-4, atol=1e-5)
NAMES = ("dgates_x", "dw_h", "dh0", "dc0")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """Pallas kernels in interpreter mode on the CPU."""
    import jax.experimental.pallas as pl

    monkeypatch.setattr(convlstm_pallas.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def inputs(b=2, t=4, h=8, w=16, c=128, seed=0):
    rng = np.random.default_rng(seed)
    gates_x = rng.normal(size=(b, t, h, w, 4 * c)).astype(np.float32) * 0.5
    w_h = rng.normal(size=(3, 3, c, 4 * c)).astype(np.float32) * 0.05
    h0 = rng.normal(size=(b, h, w, c)).astype(np.float32) * 0.1
    c0 = rng.normal(size=(b, h, w, c)).astype(np.float32) * 0.1
    return gates_x, w_h, h0, c0


def cotangents(shape, seed):
    b, t, h, w, c = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, h, w, c)).astype(np.float32),
            rng.normal(size=(b, h, w, c)).astype(np.float32),
            rng.normal(size=(b, h, w, c)).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _np(x):
    return x.detach().float().numpy()


def test_forward_ref_matches_pallas_training_forward():
    """h_seq, c_seq and the finals of ``_run_forward(with_cell_seq=True)``."""
    arrays = inputs(seed=0)
    with jax.default_matmul_precision("highest"):
        want = convlstm_pallas._run_forward(*(jnp.asarray(a) for a in arrays),
                                            with_cell_seq=True)
    h_seq, c_seq, (hf, cf) = convlstm_forward_ref(*_t(arrays), with_cell_seq=True)
    assert h_seq.dtype == c_seq.dtype == hf.dtype == cf.dtype == torch.float32
    for got, ref in zip((h_seq, c_seq, hf, cf), want):
        np.testing.assert_allclose(_np(got), np.asarray(ref), **F32)
    seq, no_cells, _ = convlstm_forward_ref(*_t(arrays))
    assert no_cells is None and torch.equal(seq, h_seq)


def _jax_grads(arrays, cots):
    dhs, dhf, dcf = (jnp.asarray(c) for c in cots)

    def loss(gx, wh, h0, c0):  # tests/test_pallas_convlstm.py's loss
        hs, (hf, cf) = convlstm_recurrence_pallas(gx, wh, h0, c0)
        return jnp.sum(hs * dhs) + jnp.sum(hf * dhf) + jnp.sum(cf * dcf)

    with jax.default_matmul_precision("highest"):
        return jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in arrays))


def _autograd(fn, arrays, cots):
    leaves = [x.requires_grad_() for x in _t(arrays)]
    hs, (hf, cf) = fn(*leaves)
    return torch.autograd.grad([hs, hf, cf], leaves, _t(cots))


@pytest.mark.parametrize("seed", [7, 11])
def test_backward_ref_matches_pallas_vjp_and_autograd(seed):
    """``convlstm_backward_ref`` == the Pallas backward kernel (through
    ``jax.grad``) == torch autograd of the plain recurrence."""
    arrays = inputs(seed=seed)
    cots = cotangents(arrays[0].shape[:4] + (arrays[0].shape[4] // 4,), seed + 1)
    h_seq, c_seq, _ = convlstm_forward_ref(*_t(arrays), with_cell_seq=True)
    got = convlstm_backward_ref(*_t(arrays), h_seq, c_seq, *_t(cots))
    for name, g, want in zip(NAMES, got, _jax_grads(arrays, cots)):
        np.testing.assert_allclose(_np(g), np.asarray(want), **F32, err_msg=name)
    for name, g, want in zip(NAMES, got, _autograd(convlstm_recurrence_ref, arrays, cots)):
        np.testing.assert_allclose(_np(g), _np(want), **F32, err_msg=name)


def test_recurrence_function_on_cpu():
    """Under autograd ``convlstm_recurrence`` goes through
    ``ConvLSTMRecurrence`` (a grad_fn, the same forward) and its gradients
    equal autograd of the plain recurrence."""
    arrays = inputs(c=16, seed=3)
    cots = cotangents((2, 4, 8, 16, 16), 4)
    leaves = [x.requires_grad_() for x in _t(arrays)]
    hs, (hf, cf) = convlstm_recurrence(*leaves)
    assert hs.grad_fn is not None and "ConvLSTMRecurrence" in type(hs.grad_fn).__name__
    rhs, (rhf, rcf) = convlstm_recurrence_ref(*_t(arrays))
    for got, ref in ((hs, rhs), (hf, rhf), (cf, rcf)):
        torch.testing.assert_close(got.detach(), ref)
    got = torch.autograd.grad([hs, hf, cf], leaves, _t(cots))
    want = _autograd(convlstm_recurrence_ref, arrays, cots)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32, err_msg=name)


def test_unused_finals_arrive_as_zeros():
    """A loss on h_seq alone: the finals' gradients are materialized as
    zeros, so the backward runs and equals autograd of the plain version."""
    arrays = inputs(b=1, t=3, h=4, w=5, c=8, seed=5)
    dhs = torch.from_numpy(cotangents((1, 3, 4, 5, 8), 6)[0])
    leaves = [x.requires_grad_() for x in _t(arrays)]
    hs, _ = convlstm_recurrence(*leaves)
    got = torch.autograd.grad((hs * dhs).sum(), leaves)
    ref_leaves = [x.requires_grad_() for x in _t(arrays)]
    rhs, _ = convlstm_recurrence_ref(*ref_leaves)
    want = torch.autograd.grad((rhs * dhs).sum(), ref_leaves)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(_np(g), _np(w), **F32, err_msg=name)


def test_bf16_dtype_contract():
    """dgates_x and dWh in the gates' and weights' type (bf16), dh0 / dc0 in
    the initial states' (f32), as ``_bwd`` returns them."""
    gx, wh, h0, c0 = _t(inputs(b=1, t=2, h=4, w=4, c=8, seed=8))
    gx, wh = gx.bfloat16(), wh.bfloat16()
    h_seq, c_seq, (hf, cf) = convlstm_forward_ref(gx, wh, h0, c0, with_cell_seq=True)
    assert h_seq.dtype == c_seq.dtype == torch.bfloat16
    assert hf.dtype == cf.dtype == torch.float32
    dhs, dhf, dcf = _t(cotangents((1, 2, 4, 4, 8), 9))
    out = convlstm_backward_ref(gx, wh, h0, c0, h_seq, c_seq, dhs.bfloat16(), dhf, dcf)
    assert [x.dtype for x in out] == [torch.bfloat16, torch.bfloat16, torch.float32,
                                      torch.float32]
    assert [tuple(x.shape) for x in out] == [tuple(gx.shape), tuple(wh.shape),
                                             tuple(h0.shape), tuple(c0.shape)]


def test_remat_changes_no_gradient():
    arrays = inputs(b=1, t=3, h=4, w=4, c=8, seed=10)
    cots = cotangents((1, 3, 4, 4, 8), 11)
    plain = _autograd(convlstm_recurrence_ref, arrays, cots)
    remat = _autograd(functools.partial(convlstm_recurrence_ref, remat=True), arrays, cots)
    for a, b in zip(plain, remat):
        torch.testing.assert_close(a, b)


def test_cpu_training_counts_no_launch():
    before = (convlstm_train_forward.launches, convlstm_backward.launches,
              convlstm_recurrence.launches)
    leaves = [x.requires_grad_() for x in _t(inputs(b=1, t=2, h=3, w=3, c=8))]
    hs, (hf, cf) = convlstm_recurrence(*leaves)
    (hs.sum() + hf.sum() + cf.sum()).backward()
    assert (convlstm_train_forward.launches, convlstm_backward.launches,
            convlstm_recurrence.launches) == before


def test_training_kernels_refuse_other_devices():
    """No silent fallback: a tensor neither on the CPU nor on CUDA raises."""
    gx = torch.empty((1, 1, 2, 2, 32), device="meta")
    wh = torch.empty((3, 3, 8, 32), device="meta")
    h0 = torch.empty((1, 2, 2, 8), device="meta")
    seq = torch.empty((1, 1, 2, 2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        convlstm_train_forward(gx, wh, h0, h0)
    with pytest.raises(ValueError, match="unsupported device"):
        convlstm_backward(gx, wh, h0, h0, seq, seq, seq, h0, h0)
    with pytest.raises(ValueError, match="unsupported device"):
        ConvLSTMRecurrence.apply(gx, wh.requires_grad_(), h0, h0)
    assert convlstm_ops.convlstm_recurrence is convlstm_recurrence


def test_fused_first_block_is_inference_only():
    """The fused u8 block has no backward: on a non-CPU device it raises when
    autograd would differentiate its weights, and otherwise reaches the
    device check."""
    u8 = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    weight = torch.empty(32, 3, 3, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        encoder_fused.fused_first_block(u8, weight, torch.empty(32))
    with torch.no_grad(), pytest.raises(ValueError, match="unsupported device"):
        encoder_fused.fused_first_block(u8, weight, torch.empty(32))
