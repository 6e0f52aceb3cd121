"""Kernel 4's tensor-core arithmetic, checked on the CPU.

Kernel 4 (``vad_tpu_torch/csrc/first_block.cu``) runs the fused first
block's conv as bf16 MMAs with f32 accumulation: its A operand is the
im2col of the raw bytes, read as 32-bit pairs of the bf16 window (K = 27
taps and 5 zero rows in ``encoder_fused.pair_rows`` order, which depends
on the parity of a pixel's first byte), its B operand the folded f32
weight in that order, split by the wrapper into bf16 terms
(``encoder_fused.weight_terms``).  The kernel itself runs only on the card
(chip_smoke.py holds it against ``fused_first_block_ref`` there); these
tests hold its arithmetic: the split, the row order, the operands'
exactness, and a float64 emulation of its sum against the JAX package's
Pallas kernel in interpret mode.

Bars: f32 rtol 1e-4 / atol 1e-5 (tests/test_pallas_convlstm.py's); bf16
output rtol 0.05 / atol 0.02.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vad_tpu.ops import encoder_pallas
from vad_tpu.ops.encoder_pallas import fold_first_block_params
from vad_tpu_torch.ops import encoder_fused
from vad_tpu_torch.ops.encoder_fused import (
    K_PAD,
    K_TAPS,
    PAD_U8,
    WEIGHT_TERMS,
    fold_first_block,
    fused_first_block,
    pair_rows,
    weight_terms,
)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.02)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """Pallas kernels in interpreter mode on the CPU."""
    import jax.experimental.pallas as pl

    monkeypatch.setattr(encoder_pallas.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def block_params(rng, c1=32):
    kernel = rng.normal(size=(3, 3, 3, c1)).astype(np.float32) * 0.2
    bias = rng.normal(size=(c1,)).astype(np.float32) * 0.1
    mean = rng.normal(size=(c1,)).astype(np.float32) * 0.05
    var = rng.uniform(0.5, 2.0, size=(c1,)).astype(np.float32)
    scale = rng.normal(size=(c1,)).astype(np.float32)
    bn_bias = rng.normal(size=(c1,)).astype(np.float32) * 0.1
    return kernel, bias, mean, var, scale, bn_bias


def port_fold(params):
    kernel, *rest = (torch.from_numpy(p) for p in params)
    return fold_first_block(kernel.permute(3, 2, 0, 1), *rest)


def frames(kind, rng, f, h, w):
    if kind == "random":
        return rng.integers(0, 256, size=(f, h, w, 3), dtype=np.uint8)
    # border-heavy: 0 / 255 on the outer two rings, next to the pad
    u8 = rng.integers(100, 156, size=(f, h, w, 3), dtype=np.uint8)
    ring = np.zeros((h, w), bool)
    ring[:2], ring[-2:], ring[:, :2], ring[:, -2:] = True, True, True, True
    u8[:, ring] = np.where(rng.random((f, int(ring.sum()), 3)) < 0.5, 0, 255).astype(np.uint8)
    return u8


def jax_block(u8, params, out_dtype):
    f, h, w, _ = u8.shape
    w_band, bias_folded = fold_first_block_params(*params)
    out = encoder_pallas.fused_first_block(
        jnp.asarray(u8.reshape(f, h, w * 3)), jnp.asarray(w_band), jnp.asarray(bias_folded),
        out_dtype=out_dtype)
    return np.asarray(out, np.float32)


def taps_of(w: torch.Tensor) -> torch.Tensor:
    """The folded weight as [27 taps (dy, dx, ci), 32] and a zero row 27."""
    taps = w.double().permute(2, 3, 1, 0).reshape(K_TAPS, 32)
    return torch.cat([taps, taps.new_zeros(1, 32)])


def emulate_kernel(u8: np.ndarray, terms: torch.Tensor, bias: torch.Tensor,
                   out_dtype) -> np.ndarray:
    """Kernel 4's sum in float64, read as the kernel reads it: the conv
    pixel in column x takes, for row k of K, the value at element
    ``2*(pair % 5) + k % 2 - parity`` of its patch row ``pair // 5`` (pair
    as in ``pair_rows``), counted from the first value of its patch; the
    window's first value is that of pixel x0 - 1 at a 16-byte chunk's odd
    offset, so the patch of column x starts on an odd element (parity 1)
    when x is even.  Each parity has its own B rows.  Then the bias after
    the 2x2 max, LeakyReLU(0.2), one cast to ``out_dtype``."""
    f, h, w, _ = u8.shape
    xpad = np.pad(u8.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)),
                  constant_values=PAD_U8).reshape(f, h + 2, (w + 2) * 3)
    rows = np.pad(xpad, ((0, 0), (0, 0), (1, 1)), constant_values=PAD_U8)  # a value each side
    b = terms.double().sum(0).numpy()  # [2, K_PAD, 32]
    first = 3 * np.arange(w) + 1  # index in `rows` of each column's patch start
    conv = np.empty((f, h, w, 32))
    for parity in (0, 1):
        a = np.empty((f, h, w, K_PAD))
        for k in range(K_PAD):
            pair = 8 * (k // 16) + 4 * (k % 16 // 8) + k % 8 // 2
            dy, el = min(pair // 5, 2), 2 * (pair % 5) + k % 2 - parity
            a[..., k] = rows[:, dy:dy + h][:, :, first + el]
        cols = np.arange(w) % 2 == 1 - parity
        conv[:, :, cols] = (a @ b[parity])[:, :, cols]
    pooled = conv.reshape(f, h // 2, 2, w // 2, 2, 32).max(axis=(2, 4)) + bias.double().numpy()
    y = np.where(pooled >= 0, pooled, 0.2 * pooled)
    return torch.from_numpy(y).to(out_dtype).float().numpy()


@pytest.mark.parametrize("n_terms,rel", [(1, 2.0**-8), (2, 2.0**-16), (3, 2.0**-22)])
@pytest.mark.parametrize("seed", (0, 1))
def test_weight_terms_reconstruct_the_folded_weight(n_terms, rel, seed):
    """hi (+ mid (+ lo)) rebuilds the f32 weight in both parities' row
    orders to the terms' precision: bf16 rounds to 8 significant bits (unit
    roundoff 2^-8) a term; three carry all 24 of f32."""
    w, _ = port_fold(block_params(np.random.default_rng(seed)))
    terms = weight_terms(w, n_terms)
    assert terms.shape == (n_terms, 2, K_PAD, 32) and terms.dtype == torch.bfloat16
    want = taps_of(w)[pair_rows()]
    got = terms.double().sum(0)
    assert bool(((got - want).abs() <= rel * want.abs()).all())


@pytest.mark.parametrize("n_terms", (1, 2, 3))
def test_weight_terms_layout_and_zero_rows(n_terms):
    """Each parity's rows hold every tap once and 5 zero rows; the two rows
    of a pair are neighbouring values of one patch row (one 32-bit load
    reads them), and a pair's zero row is the value just outside the row's
    nine."""
    w, _ = port_fold(block_params(np.random.default_rng(3)))
    terms = weight_terms(w, n_terms)
    rows = pair_rows()
    zero = {0: [9, 19, 29, 30, 31], 1: [0, 10, 20, 30, 31]}
    for parity in (0, 1):
        assert sorted(rows[parity].tolist()) == list(range(K_TAPS)) + [K_TAPS] * 5
        assert [k for k in range(K_PAD) if rows[parity, k] == K_TAPS] == zero[parity]
        assert not bool(terms[:, parity, zero[parity]].float().abs().max() > 0)
        for k in range(0, K_PAD, 2):
            lo, hi = rows[parity, k].item(), rows[parity, k + 1].item()
            if K_TAPS not in (lo, hi):
                assert hi == lo + 1 and lo // 9 == hi // 9
    hi = terms[0].float()
    for parity, k, (dy, dx, ci) in ((0, 0, (0, 0, 0)), (0, 10, (1, 0, 0)), (1, 1, (0, 0, 0)),
                                    (1, 28, (2, 2, 1))):
        assert torch.equal(hi[parity, k], w[:, ci, dy, dx].to(torch.bfloat16).float())


def test_bytes_and_pad_exact_in_bf16():
    """Every u8 value and the pad 127.5 round-trip through bf16 exactly, so
    the A operand loses nothing."""
    vals = torch.cat([torch.arange(256, dtype=torch.float32), torch.tensor([PAD_U8])])
    assert PAD_U8 == 127.5
    assert torch.equal(vals.to(torch.bfloat16).float(), vals)


def test_weight_terms_per_output_dtype():
    assert WEIGHT_TERMS == {torch.float32: 3, torch.bfloat16: 2}


def test_split_is_cached_per_tensor_and_version():
    """The wrapper reuses a weight's split while it is the same tensor at
    the same version, and splits anew after an in-place update or for
    another tensor."""
    w, _ = port_fold(block_params(np.random.default_rng(5)))
    first = encoder_fused._cached_terms(w, 2)
    assert encoder_fused._cached_terms(w, 2) is first
    w.mul_(2.0)
    again = encoder_fused._cached_terms(w, 2)
    assert again is not first
    torch.testing.assert_close(again.float(), weight_terms(w, 2).float(), rtol=0, atol=0)
    other = w.clone()
    assert encoder_fused._cached_terms(other, 2) is not again


@pytest.mark.parametrize("kind", ("random", "border"))
@pytest.mark.parametrize("f,h,w", [(2, 32, 32), (1, 34, 64), (1, 34, 50)],
                         ids=("32x32", "34x64", "34x50"))
@pytest.mark.parametrize("out", ("f32", "bf16"))
def test_emulated_kernel_matches_pallas_kernel(kind, f, h, w, out):
    """The kernel's sum (u8 window pairs x the stacked bf16 terms it gets
    for the output dtype) against JAX's fused block, in f32 at the f32 bar
    and in bf16 at the bf16 bar, and against the port's plain version.
    34x64 has 17 pooled rows (a ragged last band of 8); 34x50 has rows of
    150 bytes, off 16 (the kernel's masked path), which the Pallas kernel
    does not take (it needs W % 32 == 0): there the plain version, held
    against JAX in tests/test_torch_kernels.py, is the reference."""
    rng = np.random.default_rng(4)
    params = block_params(rng)
    u8 = frames(kind, rng, f, h, w)
    wt, bt = port_fold(params)
    t_dtype, j_dtype, bar = ((torch.float32, jnp.float32, F32) if out == "f32"
                             else (torch.bfloat16, jnp.bfloat16, BF16))
    got = emulate_kernel(u8, weight_terms(wt, WEIGHT_TERMS[t_dtype]), bt, t_dtype)
    assert got.shape == (f, h // 2, w // 2, 32)
    if w % 32 == 0:
        np.testing.assert_allclose(got, jax_block(u8, params, j_dtype), **bar)
    plain = fused_first_block(torch.from_numpy(u8), wt, bt, out_dtype=t_dtype).float().numpy()
    np.testing.assert_allclose(got, plain, **bar)
