"""The PyTorch port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version (the CUDA kernels
run only on the card; chip_smoke.py holds them against these same plain
versions there).  The Pallas kernels run in interpreter mode, as the JAX
package's own tests run them.  Inputs come from a numpy seed.

Bars: f32 rtol 1e-4 / atol 1e-5 (tests/test_pallas_convlstm.py's);
bf16 with f32 cell state rtol 0.05 / atol 0.02.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vad_tpu.ops import convlstm_pallas, encoder_pallas
from vad_tpu.ops.convlstm_pallas import convlstm_recurrence_pallas
from vad_tpu.ops.encoder_pallas import fold_first_block_params
from vad_tpu_torch.ops import encoder_fused
from vad_tpu_torch.ops.convlstm import convlstm_recurrence, convlstm_recurrence_ref
from vad_tpu_torch.ops.encoder_fused import (
    fold_first_block,
    fold_from_variables,
    fused_first_block,
    fused_first_block_ref,
)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.02)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """Pallas kernels in interpreter mode on the CPU."""
    import jax.experimental.pallas as pl

    interp = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(convlstm_pallas.pl, "pallas_call", interp)
    monkeypatch.setattr(encoder_pallas.pl, "pallas_call", interp)


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------------- kernel 1


def recurrence_inputs(b=2, t=5, h=8, w=16, c=128, seed=0):
    rng = np.random.default_rng(seed)
    gates_x = rng.normal(size=(b, t, h, w, 4 * c)).astype(np.float32) * 0.5
    w_h = rng.normal(size=(3, 3, c, 4 * c)).astype(np.float32) * 0.05
    h0 = rng.normal(size=(b, h, w, c)).astype(np.float32) * 0.1
    c0 = rng.normal(size=(b, h, w, c)).astype(np.float32) * 0.1
    return gates_x, w_h, h0, c0


def _jax_recurrence(arrays, dtype=jnp.float32):
    gx, wh, h0, c0 = (jnp.asarray(a) for a in arrays)
    with jax.default_matmul_precision("highest"):
        seq, (hf, cf) = convlstm_recurrence_pallas(gx.astype(dtype), wh.astype(dtype), h0, c0)
    return np.asarray(seq, np.float32), np.asarray(hf), np.asarray(cf)


@pytest.mark.parametrize("seed,zero_state", [(0, False), (1, True)])
def test_recurrence_matches_pallas_kernel(seed, zero_state):
    arrays = list(recurrence_inputs(seed=seed))
    if zero_state:
        arrays[2] = np.zeros_like(arrays[2])
        arrays[3] = np.zeros_like(arrays[3])
    want = _jax_recurrence(arrays)
    seq, (hf, cf) = convlstm_recurrence_ref(*(torch.from_numpy(a) for a in arrays))
    assert seq.dtype == hf.dtype == cf.dtype == torch.float32
    for got, ref in zip((seq, hf, cf), want):
        np.testing.assert_allclose(_np(got), ref, **F32)


def test_two_chunks_equal_one_run():
    """Streaming contract: chunked calls carrying (h, c) == one long call,
    and both match the Pallas kernel's chunked run."""
    gx, wh, h0, c0 = (torch.from_numpy(a) for a in recurrence_inputs(t=6, seed=2))
    full, (hf, cf) = convlstm_recurrence(gx, wh, h0, c0)
    p1, (h1, c1) = convlstm_recurrence(gx[:, :3], wh, h0, c0)
    p2, (h2, c2) = convlstm_recurrence(gx[:, 3:], wh, h1, c1)
    np.testing.assert_allclose(_np(torch.cat([p1, p2], dim=1)), _np(full), **F32)
    np.testing.assert_allclose(_np(h2), _np(hf), **F32)
    np.testing.assert_allclose(_np(c2), _np(cf), **F32)
    _, jh1, jc1 = _jax_recurrence([a.numpy()[:, :3] if i == 0 else a.numpy()
                                   for i, a in enumerate((gx, wh, h0, c0))])
    jseq2, jh2, _ = _jax_recurrence([gx.numpy()[:, 3:], wh.numpy(), jh1, jc1])
    np.testing.assert_allclose(_np(p2), jseq2, **F32)
    np.testing.assert_allclose(_np(h2), jh2, **F32)


def test_bf16_gates_keep_f32_state():
    arrays = recurrence_inputs(t=4, seed=5)
    want_seq, want_h, want_c = _jax_recurrence(arrays, jnp.bfloat16)
    gx, wh, h0, c0 = (torch.from_numpy(a) for a in arrays)
    seq, (hf, cf) = convlstm_recurrence(gx.bfloat16(), wh.bfloat16(), h0, c0)
    assert seq.dtype == torch.bfloat16 and hf.dtype == cf.dtype == torch.float32
    np.testing.assert_allclose(_np(seq), want_seq, **BF16)
    np.testing.assert_allclose(_np(hf), want_h, **BF16)
    np.testing.assert_allclose(_np(cf), want_c, **BF16)


def test_recurrence_counts_only_kernel_launches():
    """On CPU tensors the wrapper returns the plain version's result, and
    counts no launch."""
    before = convlstm_recurrence.launches
    gx, wh, h0, c0 = (torch.from_numpy(a) for a in recurrence_inputs(t=2, c=8))
    seq, (hf, cf) = convlstm_recurrence(gx, wh, h0, c0)
    rseq, (rhf, rcf) = convlstm_recurrence_ref(gx, wh, h0, c0)
    assert all(torch.equal(a, b) for a, b in ((seq, rseq), (hf, rhf), (cf, rcf)))
    assert convlstm_recurrence.launches == before


def test_recurrence_refuses_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on CUDA
    raises instead of taking the plain path."""
    gx = torch.empty((1, 1, 2, 2, 32), device="meta")
    wh = torch.empty((3, 3, 8, 32), device="meta")
    h0 = torch.empty((1, 2, 2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        convlstm_recurrence(gx, wh, h0, h0)


# ------------------------------------------------------------- kernel 4


def block_params(rng, c1=32):
    kernel = rng.normal(size=(3, 3, 3, c1)).astype(np.float32) * 0.2
    bias = rng.normal(size=(c1,)).astype(np.float32) * 0.1
    mean = rng.normal(size=(c1,)).astype(np.float32) * 0.05
    var = rng.uniform(0.5, 2.0, size=(c1,)).astype(np.float32)
    scale = rng.normal(size=(c1,)).astype(np.float32)  # sign-mixed on purpose
    bn_bias = rng.normal(size=(c1,)).astype(np.float32) * 0.1
    return kernel, bias, mean, var, scale, bn_bias


def _port_fold(params):
    kernel, *rest = (torch.from_numpy(p) for p in params)
    return fold_first_block(kernel.permute(3, 2, 0, 1), *rest)


def _jax_block(u8, params, out_dtype=jnp.float32):
    f, h, w, _ = u8.shape
    w_band, bias_folded = fold_first_block_params(*params)
    out = encoder_pallas.fused_first_block(
        jnp.asarray(u8.reshape(f, h, w * 3)), jnp.asarray(w_band), jnp.asarray(bias_folded),
        out_dtype=out_dtype,
    )
    return np.asarray(out, np.float32)


def _frames(kind, rng, f, h, w):
    if kind == "random":
        return rng.integers(0, 256, size=(f, h, w, 3), dtype=np.uint8)
    # border-heavy: extreme bytes on the frame's outer two rings, so every
    # padded tap sits next to a saturated value (0 / 255 alternate)
    u8 = rng.integers(100, 156, size=(f, h, w, 3), dtype=np.uint8)
    ring = np.zeros((h, w), bool)
    ring[:2], ring[-2:], ring[:, :2], ring[:, -2:] = True, True, True, True
    u8[:, ring] = np.where(rng.random((f, int(ring.sum()), 3)) < 0.5, 0, 255).astype(np.uint8)
    return u8


@pytest.mark.parametrize("kind,f,h,w", [("random", 2, 64, 64), ("random", 1, 32, 96),
                                        ("border", 2, 64, 64)])
def test_first_block_matches_pallas_kernel(kind, f, h, w):
    rng = np.random.default_rng(0)
    params = block_params(rng)
    u8 = _frames(kind, rng, f, h, w)
    want = _jax_block(u8, params)
    wt, bt = _port_fold(params)
    got = fused_first_block_ref(torch.from_numpy(u8), wt, bt)
    assert got.shape == (f, h // 2, w // 2, 32) and got.is_contiguous()
    np.testing.assert_allclose(_np(got), want, **F32)


def test_first_block_bf16_output():
    rng = np.random.default_rng(1)
    params = block_params(rng)
    u8 = _frames("random", rng, 1, 32, 32)
    want = _jax_block(u8, params, jnp.bfloat16)
    got = fused_first_block(torch.from_numpy(u8), *_port_fold(params), out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, **BF16)


def test_first_block_matches_unfused_block():
    """The fold is exact algebra: the fused block equals normalize + conv +
    inference BN + max-pool + LeakyReLU run as separate f32 ops."""
    import torch.nn.functional as F

    rng = np.random.default_rng(2)
    kernel, bias, mean, var, scale, bn_bias = (torch.from_numpy(p) for p in block_params(rng))
    u8 = torch.from_numpy(_frames("border", rng, 2, 32, 48))
    x = u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0
    y = F.conv2d(x, kernel.permute(3, 2, 0, 1), bias, padding=1)
    y = F.batch_norm(y, mean, var, scale, bn_bias, False, 0.0, 1e-5)
    want = F.leaky_relu(F.max_pool2d(y, 2), 0.2).permute(0, 2, 3, 1)
    got = fused_first_block(u8, *fold_first_block(kernel.permute(3, 2, 0, 1), bias, mean, var,
                                                  scale, bn_bias))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_output_views_as_channels_last():
    """Block 2 reads the NHWC output as channels-last NCHW with no copy."""
    rng = np.random.default_rng(3)
    out = fused_first_block(torch.from_numpy(_frames("random", rng, 2, 16, 16)),
                            *_port_fold(block_params(rng)))
    nchw = out.permute(0, 3, 1, 2)
    assert nchw.is_contiguous(memory_format=torch.channels_last)
    assert nchw.data_ptr() == out.data_ptr()


def test_fold_from_variables_matches_fold():
    rng = np.random.default_rng(4)
    kernel, bias, mean, var, scale, bn_bias = block_params(rng)
    variables = {
        "params": {"encoder": {"Conv_0": {"kernel": kernel, "bias": bias},
                               "BatchNorm_0": {"scale": scale, "bias": bn_bias}}},
        "batch_stats": {"encoder": {"BatchNorm_0": {"mean": mean, "var": var}}},
    }
    w1, b1 = fold_from_variables(variables)
    w2, b2 = _port_fold((kernel, bias, mean, var, scale, bn_bias))
    assert w1.shape == (32, 3, 3, 3) and b1.shape == (32,)
    torch.testing.assert_close(w1, w2)
    torch.testing.assert_close(b1, b2)


def test_fold_from_variables_refuses_group_norm():
    variables = {"params": {"encoder": {"Conv_0": {}, "GroupNorm_0": {}}}}
    with pytest.raises(ValueError, match="norm='group'"):
        fold_from_variables(variables)


def test_first_block_counts_only_kernel_launches():
    before = encoder_fused.fused_first_block.launches
    rng = np.random.default_rng(5)
    u8 = torch.from_numpy(_frames("random", rng, 1, 8, 8))
    wt, bt = _port_fold(block_params(rng))
    assert torch.equal(fused_first_block(u8, wt, bt), fused_first_block_ref(u8, wt, bt))
    assert encoder_fused.fused_first_block.launches == before


def test_first_block_refuses_other_devices():
    u8 = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_first_block(u8, torch.empty(32, 3, 3, 3), torch.empty(32))
