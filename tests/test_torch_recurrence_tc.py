"""The stepwise_tc design of the recurrence kernels, checked on the CPU.

stepwise_tc (``vad_tpu_torch/csrc/convlstm_tiles.cuh``'s f32 tile and the
``tc`` steps of ``convlstm_serving.cu`` and ``convlstm_backward.cu``) runs
the f32 recurrence on the tensor cores in 3xTF32: every f32 operand x is
split into TF32 terms big = rna(x), small = rna(x - big) (``cvt.rna``:
round to nearest, ties away, on the 13 mantissa bits TF32 drops) and a
product is small_a.big_b + big_a.small_b + big_a.big_b, accumulated in f32.
Each K stage's products go to a fresh accumulator that is then added to
the running f32 sum (a wgmma stage: 8 channels at all 9 taps; a mma.sync
stage: 16 channels of one tap); a step's K is split across a cluster's
blocks, whose partial sums are added in rank order.  The kernels run only on the card
(chip_smoke.py holds them against the plain versions there); these tests
hold the design's arithmetic, emulated in numpy float64, against the JAX
package: kernel 1's step and kernel 3's GEMMs (gate recompute, dh
product, dWh) at a small size against JAX's plain recurrence (its Pallas
kernel takes C % 128 == 0 only) and at the ``--video`` width (C=128)
against ``convlstm_recurrence_pallas`` in interpret mode; the same
emulation with one TF32 term (big.big) misses the bar.  Also the split
itself, its cached weights and the plan that picks the design.

Bar: f32 rtol 1e-4 / atol 1e-5 (tests/test_pallas_convlstm.py's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vad_tpu.models.video_autoencoder import convlstm_step as jax_convlstm_step
from vad_tpu.ops import convlstm_pallas
from vad_tpu.ops.convlstm_pallas import convlstm_recurrence_pallas
from vad_tpu_torch.ops import convlstm
from vad_tpu_torch.ops.convlstm import (
    NUM_SMS,
    SMEM_LIMIT,
    recurrence_plan,
    tc_fits,
    tf32_rna,
    tf32_split,
)

F32 = dict(rtol=1e-4, atol=1e-5)
KERNELS = ("convlstm_serving", "convlstm_train_forward", "convlstm_backward")
BF16, F32T = torch.bfloat16, torch.float32
SERVING = (16, 16, 16, 16, 128)  # S=16 streams, T=16, a 16x16 latent
TRAINING = (8, 16, 16, 16, 128)  # B=8 windows
VIDEO = (1, 16, 16, 16, 128)  # evaluate_video --video: one stream
EDGE = ((3, 3, 5, 7, 48), (2, 4, 3, 9, 20), (3, 2, 8, 8, 32), (2, 3, 8, 16, 64),
        (2, 3, 8, 32, 128))
# K chunk of a wgmma tile stage (8 channels at all 9 taps); K of the
# cp.async ring's stage (mma.sync, 16 channels of one tap)
KC, RING_BK = 8, 16


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """Pallas kernels in interpreter mode on the CPU."""
    import jax.experimental.pallas as pl

    monkeypatch.setattr(convlstm_pallas.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


# --------------------------------------------------------- the emulation


def rna(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` in numpy: f32 ``x`` rounded to 10 mantissa bits,
    ties away from zero (sign-magnitude bits: add half the dropped range,
    clear the 13 low bits)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray):
    big = rna(x)
    return big, rna(x.astype(np.float32) - big)


def tc_gemm(a: np.ndarray, b: np.ndarray, stage: int, ranks: int = 1, terms: int = 3,
            per_split: bool = False) -> np.ndarray:
    """``a [M, K] @ b [K, N]`` as stepwise_tc sums it: K in stages of
    ``stage`` (the last one short), each stage's 3xTF32 products (or one
    TF32 term, big.big, with ``terms=1``) summed exactly and rounded once to
    f32, the stages added in order to an f32 sum; the stages split over
    ``ranks`` runs as the kernels split them, whose sums are added in rank
    order in f32: a cluster's rank r takes stages [r n / ranks, (r + 1) n /
    ranks); dWh's split z (``per_split``) [z p, (z + 1) p), p = ceil(n /
    ranks)."""
    ab, as_ = split(a)
    bb, bs = split(b)
    n = -(-a.shape[1] // stage)
    per = -(-n // ranks)
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for r in range(ranks):
        acc = np.zeros_like(out)
        first, last = ((r * per, min((r + 1) * per, n)) if per_split
                       else (r * n // ranks, (r + 1) * n // ranks))
        for s in range(first, last):
            k = slice(s * stage, (s + 1) * stage)
            part = ab[:, k].astype(np.float64) @ bb[k].astype(np.float64)
            if terms == 3:
                part += as_[:, k].astype(np.float64) @ bb[k].astype(np.float64)
                part += ab[:, k].astype(np.float64) @ bs[k].astype(np.float64)
            acc = (acc + part.astype(np.float32)).astype(np.float32)
        out = (out + acc).astype(np.float32)
    return out


def im2col(x: np.ndarray, chunk: int, reverse: bool = False,
           taps_inner: bool = False) -> np.ndarray:
    """``x [B, H, W, K]`` -> ``[B*H*W, 9 * Kp]`` in a kernel's K order, K
    padded with zeros to a multiple of ``chunk``: tap-major (row-major 3x3,
    the ring's stages never span two taps) or, ``taps_inner``, chunk-major
    (the wgmma tile's stages: ``chunk`` channels at all 9 taps).  The
    forward's tap (dy, dx) reads pixel (y + dy - 1, x + dx - 1);
    ``reverse`` (kernel 3's dh product) reads (y + 1 - dy, x + 1 - dx).
    Outside the frame: 0."""
    b, h, w, k = x.shape
    kp = -(-k // chunk) * chunk
    pad = np.zeros((b, h + 2, w + 2, kp), np.float32)
    pad[:, 1:-1, 1:-1, :k] = x
    cols = []
    for tap in range(9):
        dy, dx = tap // 3, tap % 3
        if reverse:
            dy, dx = 2 - dy, 2 - dx
        cols.append(pad[:, dy:dy + h, dx:dx + w].reshape(b * h * w, kp))
    cols = np.stack(cols, 1)  # [pixels, tap, Kp]
    if taps_inner:
        cols = cols.reshape(b * h * w, 9, kp // chunk, chunk).transpose(0, 2, 1, 3)
    return np.ascontiguousarray(cols).reshape(b * h * w, 9 * kp)


def tap_rows(w: np.ndarray, chunk: int, taps_inner: bool = False) -> np.ndarray:
    """``w [9, K, N]`` -> ``[9 * Kp, N]`` in im2col's K order (K padded
    with zero rows to a multiple of ``chunk``)."""
    k = w.shape[1]
    kp = -(-k // chunk) * chunk
    out = np.zeros((9, kp, w.shape[2]), np.float32)
    out[:, :k] = w
    if taps_inner:
        out = out.reshape(9, kp // chunk, chunk, w.shape[2]).transpose(1, 0, 2, 3)
    return np.ascontiguousarray(out).reshape(9 * kp, w.shape[2])


def sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x.astype(np.float64)))).astype(np.float32)


def tanh(x):
    return np.tanh(x.astype(np.float64)).astype(np.float32)


def emulate_forward(gx, wh, h0, c0, terms=3):
    """Kernels 1 and 2 in stepwise_tc: each step's gates = gates_x[t] +
    the 3xTF32 GEMM of im2col(h_{t-1}) with Wh (the plan's K split), then
    the gate math in f32.  Returns (h_seq, c_seq, h_T, c_T)."""
    b, t_len, h, w, four_c = gx.shape
    ch = four_c // 4
    ranks = recurrence_plan("convlstm_serving", b, t_len, h, w, ch, F32T).cluster
    wmat = tap_rows(wh.reshape(9, ch, four_c), KC, taps_inner=True)
    hs, cs, hcur, c = [], [], h0, c0
    for t in range(t_len):
        conv = tc_gemm(im2col(hcur, KC, taps_inner=True), wmat, 9 * KC, ranks, terms)
        gates = gx[:, t].reshape(-1, four_c) + conv
        i, f, g, o = (gates[:, j * ch:(j + 1) * ch] for j in range(4))
        c = (sigmoid(f) * c.reshape(-1, ch) + sigmoid(i) * tanh(g)).reshape(c0.shape)
        hcur = (sigmoid(o) * tanh(c.reshape(-1, ch))).reshape(h0.shape)
        hs.append(hcur)
        cs.append(c)
    return np.stack(hs, 1), np.stack(cs, 1), hcur, c


def emulate_backward(gx, wh, h0, c0, h_seq, c_seq, dh_seq, dhf, dcf, terms=3):
    """Kernel 3 in stepwise_tc: the gate recompute over every frame and the
    reverse loop's dh product on the wgmma tile (3xTF32 per chunk of 8
    channels or gate columns at all 9 taps, each in the plan's cluster
    split), dh0 and dWh on the cp.async ring's mma.sync path (3xTF32 per
    16 of K; dWh's K, the pixels, split as the plan splits it and summed in
    split order).  Mirrors
    ``convlstm_backward_ref`` with those GEMMs.  Returns (dgates_x, dWh,
    dh0, dc0)."""
    b, t_len, h, w, four_c = gx.shape
    ch = four_c // 4
    plan = recurrence_plan("convlstm_backward", b, t_len, h, w, ch, F32T)
    w9 = wh.reshape(9, ch, four_c)
    w_fwd = tap_rows(w9, KC, taps_inner=True)  # [(chunk, tap, c), n]
    w_dh = tap_rows(np.ascontiguousarray(w9.transpose(0, 2, 1)), KC,
                    taps_inner=True)  # [(chunk, tap, n), c]
    w_dh0 = tap_rows(np.ascontiguousarray(w9.transpose(0, 2, 1)), RING_BK)
    prev = np.concatenate([h0[:, None], h_seq[:, :-1]], 1)  # h_{t-1}
    act = tc_gemm(im2col(prev.reshape(-1, h, w, ch), KC, taps_inner=True), w_fwd, 9 * KC,
                  plan.gate_groups, terms)
    act = act.reshape(b, t_len, h, w, four_c) + gx
    act = np.concatenate([sigmoid(act[..., :2 * ch]), tanh(act[..., 2 * ch:3 * ch]),
                          sigmoid(act[..., 3 * ch:])], -1)
    dgates = np.zeros_like(gx)
    dh, dc = dhf, dcf
    for t in reversed(range(t_len)):
        if t < t_len - 1:
            dh = tc_gemm(im2col(dgates[:, t + 1], KC, reverse=True, taps_inner=True), w_dh,
                         9 * KC, plan.cluster, terms).reshape(dh.shape)
        i, f, g, o = (act[:, t, ..., j * ch:(j + 1) * ch] for j in range(4))
        tanh_ct = tanh(c_seq[:, t])
        c_prev = c0 if t == 0 else c_seq[:, t - 1]
        dh_total = dh_seq[:, t] + dh
        dc_total = dc + dh_total * o * (1.0 - tanh_ct * tanh_ct)
        dgates[:, t] = np.concatenate([dc_total * g * i * (1.0 - i),
                                       dc_total * c_prev * f * (1.0 - f),
                                       dc_total * i * (1.0 - g * g),
                                       dh_total * tanh_ct * o * (1.0 - o)], -1)
        dc = (dc_total * f).astype(np.float32)
    dh0 = tc_gemm(im2col(dgates[:, 0], RING_BK, reverse=True), w_dh0, RING_BK, 1,
                  terms).reshape(h0.shape)
    # dWh: rows (tap, c) x columns n over every pixel of every step
    cols = im2col(prev.reshape(-1, h, w, ch), 1)  # [pixels, 9C], K order per pixel
    dmat = dgates.reshape(-1, four_c)
    dw = tc_gemm(np.ascontiguousarray(cols.T), dmat, RING_BK, plan.dw_splits, terms,
                 per_split=True)
    return dgates, dw.reshape(3, 3, ch, four_c), dh0, dc


# ------------------------------------------------------------- JAX side


def inputs(b, t, h, w, c, seed):
    rng = np.random.default_rng(seed)
    gx = rng.normal(size=(b, t, h, w, 4 * c)).astype(np.float32) * 0.5
    wh = rng.normal(size=(3, 3, c, 4 * c)).astype(np.float32) * 0.05
    h0 = rng.normal(size=(b, h, w, c)).astype(np.float32) * 0.1
    c0 = rng.normal(size=(b, h, w, c)).astype(np.float32) * 0.1
    cots = (rng.normal(size=(b, t, h, w, c)).astype(np.float32),
            rng.normal(size=(b, h, w, c)).astype(np.float32),
            rng.normal(size=(b, h, w, c)).astype(np.float32))
    return (gx, wh, h0, c0), cots


def jax_scan(gx, wh, h0, c0):
    """JAX's plain recurrence: ``lax.scan`` of ``convlstm_step``."""
    def step(carry, g_t):
        h, c = convlstm_step_carry(carry, g_t, wh)
        return (h, c), (h, c)

    (hf, cf), (hs, cs) = jax.lax.scan(step, (h0, c0), jnp.moveaxis(gx, 1, 0))
    return jnp.moveaxis(hs, 0, 1), jnp.moveaxis(cs, 0, 1), hf, cf


def convlstm_step_carry(carry, g_t, wh):
    h, c = carry
    return jax_convlstm_step(g_t, h, c, wh)


def jax_reference(arrays, cots, pallas: bool):
    """(h_seq, c_seq, h_T, c_T) and the VJP (dgates_x, dWh, dh0, dc0) of
    the JAX package at ``highest`` precision: ``convlstm_recurrence_pallas``
    (its kernels in interpret mode) where it takes the width, else the
    plain scan."""
    x = [jnp.asarray(a) for a in arrays]
    dhs, dhf, dcf = (jnp.asarray(c) for c in cots)
    with jax.default_matmul_precision("highest"):
        hs, cs, hf, cf = jax_scan(*x)
        if pallas:
            hs_p, (hf_p, cf_p) = convlstm_recurrence_pallas(*x)
            _, cs_p, _, _ = convlstm_pallas._run_forward(*x, with_cell_seq=True)
            hs, cs, hf, cf = hs_p, cs_p, hf_p, cf_p
            recurrence = convlstm_recurrence_pallas
        else:
            def recurrence(*a):
                h_seq, _, h_t, c_t = jax_scan(*a)
                return h_seq, (h_t, c_t)

        def loss(*a):
            h_seq, (h_t, c_t) = recurrence(*a)
            return jnp.sum(h_seq * dhs) + jnp.sum(h_t * dhf) + jnp.sum(c_t * dcf)

        grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*x)
    return [np.asarray(v) for v in (hs, cs, hf, cf)], [np.asarray(g) for g in grads]


def misses(got, want) -> bool:
    return not np.allclose(got, want, **F32)


# the small case (JAX's plain scan) and the --video width (Pallas)
CASES = {"small": ((2, 3, 8, 8, 32), False), "video_width": ((1, 2, 8, 8, 128), True)}


@pytest.fixture(scope="module")
def reference():
    """Each case's inputs, cotangents and JAX's forward and VJP (computed
    once a module; the Pallas kernels in interpret mode)."""
    out = {}
    real = convlstm_pallas.pl.pallas_call
    convlstm_pallas.pl.pallas_call = functools.partial(real, interpret=True)
    try:
        for name, (shape, pallas) in CASES.items():
            arrays, cots = inputs(*shape, seed=sum(shape))
            out[name] = (arrays, cots, *jax_reference(arrays, cots, pallas))
    finally:
        convlstm_pallas.pl.pallas_call = real
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_forward_emulation_matches_jax(reference, case):
    """Kernels 1 and 2's 3xTF32 step, emulated, against JAX's forward."""
    arrays, _, fwd, _ = reference[case]
    got = emulate_forward(*arrays)
    for name, g, w in zip(("h_seq", "c_seq", "h_T", "c_T"), got, fwd):
        np.testing.assert_allclose(g, w, **F32, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_emulation_matches_jax(reference, case):
    """Kernel 3's 3xTF32 GEMMs (gate recompute, dh product, dh0, dWh with
    its split sum), emulated on JAX's own forward sequences, against
    JAX's VJP."""
    arrays, cots, fwd, grads = reference[case]
    got = emulate_backward(*arrays, fwd[0], fwd[1], *cots)
    for name, g, w in zip(("dgates_x", "dw_h", "dh0", "dc0"), got, grads):
        np.testing.assert_allclose(g, w, **F32, err_msg=name)


def test_one_tf32_term_misses_the_bar(reference):
    """The same emulation with one TF32 term (big.big, a plain TF32 pass)
    misses the f32 bar on every output of both cases: why the design takes
    three."""
    kept = []
    for case, (arrays, cots, fwd, grads) in reference.items():
        got_f = emulate_forward(*arrays, terms=1)
        got_b = emulate_backward(*arrays, fwd[0], fwd[1], *cots, terms=1)
        kept += [f"{case} {name}" for name, g, w in zip(
            ("h_seq", "c_seq", "h_T", "c_T", "dgates_x", "dw_h", "dh0", "dc0"),
            (*got_f, *got_b), (*fwd, *grads)) if not misses(g, w)]
    assert not kept, f"one TF32 term stayed within the f32 bar on {kept}"


def test_emulated_dwh_is_the_split_order_sum():
    """dWh's K split: the splits' partial sums added in split order, as the
    finish launch adds them, is one fixed order; the same inputs give the
    same bits however often the sum is taken."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(36, 300)).astype(np.float32)
    b = rng.normal(size=(300, 20)).astype(np.float32)
    one = tc_gemm(a, b, RING_BK, ranks=3, per_split=True)
    assert np.array_equal(one, tc_gemm(a, b, RING_BK, ranks=3, per_split=True))
    np.testing.assert_allclose(one, a.astype(np.float64) @ b, rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------ the split


def test_rna_matches_the_emulation_bit_for_bit():
    """``tf32_rna`` (the wrapper's weight split) equals the emulation's
    ``cvt.rna``: ties go away from zero, 13 low bits clear, both signs."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=4000) * 10.0 ** rng.integers(-6, 6, 4000),
                        [0.0, -0.0, 1e-30, -1e-30, 3.4e38]]).astype(np.float32)
    bits = x.view(np.uint32)
    ties = ((bits & np.uint32(0xFFFFE000)) | np.uint32(0x1000)).view(np.float32)
    for v in (x, ties):
        got = tf32_rna(torch.from_numpy(v)).numpy()
        assert np.array_equal(got.view(np.uint32), rna(v).view(np.uint32))
        assert not (got.view(np.uint32) & np.uint32(0x1FFF)).any()
    up = tf32_rna(torch.from_numpy(ties)).numpy()
    assert (np.abs(up) >= np.abs(ties)).all()  # a tie rounds away from zero


def test_split_terms_sum_to_f32():
    """big + small is x to about 2^-22; big alone only to 2^-11."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=10000).astype(np.float32))
    big, small = tf32_split(x)
    rel = ((big.double() + small.double() - x.double()).abs() / x.double().abs()).max()
    assert rel < 2.0 ** -21
    assert ((big.double() - x.double()).abs() / x.double().abs()).max() > 2.0 ** -14
    assert tf32_split(x).shape == (2, 10000)


@pytest.mark.parametrize("c", (8, 20))
def test_weight_layout_rows(c):
    """``tc_weight_layout``: tile t, chunk kc, tap, row n, value j holds, in
    kernels 1-2's layout, Wh[tap][8 kc + j][gate n // 16, channel 16 t +
    n % 16]; in kernel 3's, Wh[tap][channel 64 t + n][gate column 8 kc + j];
    zeros past C."""
    w = torch.from_numpy(np.random.default_rng(c).normal(size=(3, 3, c, 4 * c)).astype(
        np.float32))
    w9 = w.reshape(9, c, 4 * c).numpy()
    fwd = convlstm.tc_weight_layout(w, "fwd").numpy()
    bwd = convlstm.tc_weight_layout(w, "bwd").numpy()
    assert fwd.shape == (-(-c // 16), -(-c // 8), 9, 64, 8)
    assert bwd.shape == (-(-c // 64), 4 * c // 8, 9, 64, 8)
    t, kc, tap, n, j = np.meshgrid(*(np.arange(d) for d in fwd.shape), indexing="ij")
    ch, cin = 16 * t + n % 16, 8 * kc + j
    ok = (ch < c) & (cin < c)
    want = np.where(ok, w9[tap, np.minimum(cin, c - 1), n // 16 * c + np.minimum(ch, c - 1)], 0)
    np.testing.assert_array_equal(fwd, want)
    t, kc, tap, n, j = np.meshgrid(*(np.arange(d) for d in bwd.shape), indexing="ij")
    ch = 64 * t + n
    want = np.where(ch < c, w9[tap, np.minimum(ch, c - 1), 8 * kc + j], 0)
    np.testing.assert_array_equal(bwd, want)


def test_weight_split_is_cached_per_tensor_and_version():
    """Wh's split stage images (``[tiles, chunks, 9 taps, 2 planes, 2
    groups, 64 rows, 4]``, 36,864 bytes a stage) are made once per weight
    tensor, version and storage, in each kernel's layout, and made again
    after an in-place update or a storage swap (``p.data = x``)."""
    c = 8
    w = torch.from_numpy(np.random.default_rng(2).normal(size=(3, 3, c, 4 * c)).astype(
        np.float32))
    fwd = convlstm._tc_weights(w, "fwd")
    bwd = convlstm._tc_weights(w, "bwd")
    assert fwd.shape == (1, 1, 9, 2, 2, 64, 4) and bwd.shape == (1, 4, 9, 2, 2, 64, 4)
    assert fwd[0, 0].numel() * 4 == 36_864
    rows = convlstm.tc_weight_layout(w, "fwd")  # [1, 1, 9, 64, 8]
    big, small = tf32_split(rows)
    # plane p, group g, row n, value e = term p of rows[..., n, 4 g + e]
    torch.testing.assert_close(fwd[0, 0, 5, 0, 1, 17], big[0, 0, 5, 17, 4:], rtol=0, atol=0)
    torch.testing.assert_close(fwd[0, 0, 5, 1, 0, 40], small[0, 0, 5, 40, :4], rtol=0, atol=0)
    assert convlstm._tc_weights(w, "fwd") is fwd and convlstm._tc_weights(w, "bwd") is bwd
    w.mul_(2.0)
    again = convlstm._tc_weights(w, "fwd")
    assert again is not fwd
    torch.testing.assert_close(again, convlstm.tc_stage_images(w, "fwd"), rtol=0, atol=0)
    w.data = w.detach().clone() + 1.0
    swapped = convlstm._tc_weights(w, "fwd")
    assert swapped is not again
    torch.testing.assert_close(swapped, convlstm.tc_stage_images(w, "fwd"), rtol=0, atol=0)


# ------------------------------------------------------------- the plan


@pytest.mark.parametrize("shape", (SERVING, TRAINING, VIDEO, *EDGE),
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kernel", KERNELS)
def test_stepwise_tc_is_f32s_choice(kernel, shape):
    plan = recurrence_plan(kernel, *shape, F32T)
    assert plan.design == "stepwise_tc" and tc_fits(shape[4], F32T, shape[3])
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.cluster in (1, 2, 4, 8) and plan.grids["step"][0] == plan.cluster
    assert plan.warpgroups in (1, 2)
    assert plan.step_blocks == int(np.prod(plan.grids["step"]))
    b, t, h, w, c = shape
    # every tile of 64 pixels a warpgroup, and a K chunk for every rank
    assert plan.grids["step"][2] * 64 * plan.warpgroups >= b * h * w
    assert plan.cluster <= -(-(c if kernel != "convlstm_backward" else 4 * c) // 8)


@pytest.mark.parametrize("shape", (SERVING, TRAINING, VIDEO), ids=("serving", "training",
                                                                  "video"))
@pytest.mark.parametrize("kernel", KERNELS)
def test_stepwise_tc_fills_the_card(kernel, shape):
    """At least one block a step per SM, except where the plan's docstring
    says why not: kernel 3 at B*H*W <= 256 (its 64-channel tile, 8 blocks
    a portable cluster)."""
    plan = recurrence_plan(kernel, *shape, F32T)
    b, _, h, w, _ = shape
    if kernel == "convlstm_backward" and b * h * w <= 256:
        assert plan.step_blocks == 64 and plan.cluster == 8
        assert "B*H*W <= 256" in recurrence_plan.__doc__
    else:
        assert plan.step_blocks >= NUM_SMS


@pytest.mark.parametrize("shape", (SERVING, TRAINING, VIDEO), ids=("serving", "training",
                                                                  "video"))
def test_stepwise_tc_launches(shape):
    """Launches per call, what the wrappers add to the counters: one a
    step for kernels 1 and 2; kernel 3's T steps plus its gate, dWh and
    finish launches, as the stepwise design."""
    t = shape[1]
    for kernel, launches in zip(KERNELS, (t, t, t + 3)):
        plan = recurrence_plan(kernel, *shape, F32T)
        assert plan.launches == launches
        assert plan.launches == recurrence_plan(kernel, *shape, F32T, design="stepwise").launches


def test_stepwise_tc_grids_at_the_slice_shapes():
    """The grids the H100 runs: (cluster, channel tiles, pixel tiles)."""
    assert recurrence_plan("convlstm_serving", *SERVING, F32T).grids["step"] == (1, 8, 32)
    assert recurrence_plan("convlstm_train_forward", *TRAINING, F32T).grids["step"] == (2, 8, 16)
    assert recurrence_plan("convlstm_serving", *VIDEO, F32T).grids["step"] == (8, 8, 4)
    back = recurrence_plan("convlstm_backward", *TRAINING, F32T)
    assert back.grids["step"] == (8, 2, 16) and back.warpgroups == 2
    # the gate recompute: kernel 1's GEMM over all B*T frames, 256 tiles of 128 pixels
    assert back.grids["gate"] == (1, 8, 256) == (back.gate_groups, 8, 256)
    assert back.gate_warpgroups == 2
    stepwise = recurrence_plan("convlstm_backward", *TRAINING, F32T, design="stepwise")
    for part in ("dw", "finish"):  # dWh and the last launch are the stepwise ones, on mma.sync
        assert back.grids[part] == stepwise.grids[part]
    assert back.dw_splits == stepwise.dw_splits and back.scratch_bytes == stepwise.scratch_bytes


@pytest.mark.parametrize("kernel", KERNELS)
def test_naming_stepwise_tc_where_it_does_not_fit_raises(kernel):
    # bf16 stepwise_tc takes every kernel with C % 8 == 0 (kernel 3's since
    # PR 17): T launches for kernels 1-2, T + 3 for kernel 3
    launches = 19 if kernel == "convlstm_backward" else 16
    assert recurrence_plan(kernel, *TRAINING, BF16, design="stepwise_tc").launches == launches
    with pytest.raises(ValueError, match="stepwise_tc design does not take"):
        recurrence_plan(kernel, 2, 3, 8, 8, 20, BF16, design="stepwise_tc")
    with pytest.raises(ValueError, match="stepwise_tc design does not take"):
        recurrence_plan(kernel, 2, 3, 8, 8, 30, F32T, design="stepwise_tc")
    # C % 4 != 0 in f32 takes the FMA design
    assert recurrence_plan(kernel, 2, 3, 8, 8, 30, F32T).design == "stepwise"
    assert not tc_fits(30, F32T, 8) and not tc_fits(20, BF16, 8)
    assert tc_fits(128, BF16, 8)


def test_row_form_refuses_stepwise_tc():
    """The row form takes stepwise_tc wherever ``tc_fits``: its choice
    unless the stepwise design is named; named where it does not fit (C %
    4 != 0 in f32, C % 8 != 0 in bf16), it raises."""
    plan = recurrence_plan("convlstm_serving", *SERVING, F32T, design="stepwise_tc", shards=2)
    assert plan.design == "stepwise_tc" == recurrence_plan(
        "convlstm_serving", *SERVING, F32T, shards=2).design
    assert recurrence_plan("convlstm_serving", *SERVING, F32T, design="stepwise",
                           shards=2).design == "stepwise"
    for c, dtype in ((30, F32T), (20, BF16)):
        with pytest.raises(ValueError, match="stepwise_tc design does not take the row form"):
            recurrence_plan("convlstm_serving", 2, 3, 8, 8, c, dtype, design="stepwise_tc",
                            shards=2)
        assert recurrence_plan("convlstm_serving", 2, 3, 8, 8, c, dtype,
                               shards=2).design == "stepwise"
