"""Kernel 3's bf16 form on the stepwise_tc tile, checked on the CPU.

Beyond the resident design's frames (a 32x32 latent of 512x512 frames,
8x40, 24x24) kernel 3 runs in bf16 on the wgmma step tile
(``vad_tpu_torch/csrc/convlstm_backward.cu``, namespace ``tc``):

- the gate recompute (``gate_tc``): kernel 1's GEMM over all B*T frames,
  chunks of 16 input channels at all 9 taps, one wgmma m64n64k16 a tap
  against the ``"fwd"`` stage images, a cluster splitting the chunks and
  summing its partial tiles in rank order; the activations in f32;
- the reverse loop (``dh_tc_step``): dh_t = the correlation of the stored
  bf16 dgates[t+1] with Wh's taps reversed, chunks of 16 gate columns
  against the ``"bwd"`` stage images (a row per output channel), the same
  cluster sum, then the f32 gate epilogue storing dgates_x in bf16;
- dWh (``dw_tc``): both operands pixel-major, K = every pixel of every
  step in units of R rows x SW columns of a frame (SW = W rounded up to
  16, at most 64; R = 128 / SW), one wgmma a 16-pixel K step, the units
  split into f32 partials summed in split order;
- dh0 (``finish_tc``): the loop's dh product over dgates[0].

The kernels run only on the card (chip_smoke.py holds them against the
plain version and PR 1's core there); these tests emulate their sums in
numpy (bf16 operands, each wgmma's products exact then rounded to f32 and
added to an f32 sum, in the kernels' order) and hold the emulation
against the JAX package (``_run_backward`` through the custom VJP of
``convlstm_recurrence_pallas`` in interpret mode at C=128; its plain
scan's VJP at C=16 and 24, which its Pallas kernel does not take) and
against the port's ``convlstm_backward_ref``.  JAX's kernel forms dh and
dWh from its f32 dgates, the port's bf16 designs from the stored bf16
dgates_x: inside the bar.  Also the stage images, the units and split
order of dWh, and the plan.

Bar: bf16 rtol 0.05 / atol 0.02, and rel L2 <= 0.05 (chip_smoke.py's
``agree``); dWh's atol scales with max |dWh| above 1 (a long sum).
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
from vad_tpu_torch.ops.convlstm import recurrence_plan, tc_fits, tc_stage_images

BF16_BAR = dict(rtol=0.05, atol=0.02)
BF16 = torch.bfloat16
KC = 16  # a bf16 K chunk: 16 channels (gate recompute) or gate columns (dh) at all 9 taps
# (B, T, H, W, C) the resident design refuses: 24x24 (nine 8x8 tiles) at
# C=16, 8x40 (W % 16 != 0) at C=24 with a half-empty last chunk, and 8x40
# at C=128, where JAX's Pallas kernel runs (C % 128 == 0)
SMALL = ((2, 3, 24, 24, 16), (2, 3, 8, 40, 24))
PALLAS = (1, 2, 8, 40, 128)
NAMES = ("dgates_x", "dw_h", "dh0", "dc0")


def bf16(x) -> np.ndarray:
    """``x`` rounded to bf16 (to nearest, ties to even), as f32 values."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(BF16).float().numpy()


def f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def sigmoid(x):
    return f32(1.0 / (1.0 + np.exp(-x.astype(np.float64))))


def tanh(x):
    return f32(np.tanh(x.astype(np.float64)))


def taps(x: np.ndarray, reverse: bool = False) -> np.ndarray:
    """``x [N, H, W, K]`` -> ``[9, N*H*W, K]``: tap (dy, dx) of each pixel,
    zero outside the frame.  The forward's tap reads pixel (y + dy - 1, x +
    dx - 1); ``reverse`` (the dh product) reads (y + 1 - dy, x + 1 - dx)."""
    n, h, w, k = x.shape
    pad = np.zeros((n, h + 2, w + 2, k), np.float32)
    pad[:, 1:-1, 1:-1] = x
    out = []
    for tap in range(9):
        dy, dx = tap // 3, tap % 3
        if reverse:
            dy, dx = 2 - dy, 2 - dx
        out.append(pad[:, dy:dy + h, dx:dx + w].reshape(n * h * w, k))
    return np.stack(out)


def b_tile(images: np.ndarray, nt: int, kc: int, tap: int) -> np.ndarray:
    """B of (column tile nt, chunk kc, tap) as wgmma reads the stage image:
    K-major core matrices, element (k, n) at [k // 8][n][k % 8] -> ``[16,
    64]``."""
    return images[nt, kc, tap].transpose(0, 2, 1).reshape(KC, 64)


def tile_sum(cols: np.ndarray, images: np.ndarray, ranks: int) -> np.ndarray:
    """The tile's GEMM: ``cols [9, M, K]`` (bf16 values) against the stage
    images ``[tiles][chunks][9][2][64][8]`` -> ``[M, tiles * 64]`` f32.  Per
    chunk and tap one product (exact, rounded to f32) is added to the
    rank's f32 sum, rank r taking chunks [r n / ranks, (r + 1) n / ranks);
    the ranks' sums are added in rank order.  Every pixel tile sums its rows
    so, so the emulation runs over all pixels at once."""
    tiles, chunks = images.shape[:2]
    a = np.zeros(cols.shape[:2] + (chunks * KC,), np.float32)
    a[..., :cols.shape[2]] = cols
    out = np.zeros((cols.shape[1], tiles * 64), np.float32)
    for nt in range(tiles):
        total = np.zeros((cols.shape[1], 64), np.float32)
        for rank in range(ranks):
            acc = np.zeros_like(total)
            for kc in range(rank * chunks // ranks, (rank + 1) * chunks // ranks):
                for tap in range(9):
                    part = (a[tap, :, kc * KC:(kc + 1) * KC].astype(np.float64)
                            @ b_tile(images, nt, kc, tap).astype(np.float64))
                    acc = f32(acc + f32(part))
            total = f32(total + acc)
        out[:, nt * 64:(nt + 1) * 64] = total
    return out


def dw_units(b: int, t: int, hgt: int, wid: int):
    """dWh's K order: units (frame, row group, column segment) of R rows x
    SW columns, each walked row by row in 16-pixel K steps; yields each
    unit's K steps as lists of flat pixel indices into [B*T*H*W] (pixels
    past the frame's edge hold zero dgates and are left out)."""
    seg = min(-(-wid // 16) * 16, 64)
    rows = 128 // seg
    for f in range(b * t):
        for y0 in range(0, hgt, rows):
            for x0 in range(0, wid, seg):
                steps = []
                for y in range(y0, min(y0 + rows, hgt)):
                    for xs in range(x0, x0 + seg, 16):
                        xs_in = [x for x in range(xs, xs + 16) if x < wid]
                        if xs_in:
                            steps.append([(f * hgt + y) * wid + x for x in xs_in])
                yield steps


def emulate_dw(h_prev: np.ndarray, dg: np.ndarray, splits: int) -> np.ndarray:
    """dWh as ``dw_tc`` sums it: ``h_prev [B*T, H, W, C]`` (h_{t-1}, bf16
    values), ``dg [B*T, H, W, 4C]`` (the stored bf16 dgates) -> ``[9C,
    4C]`` f32, rows (tap, c).  Each 16-pixel K step's products (exact,
    rounded to f32) go to its split's f32 sum; split z takes units [z p, (z
    + 1) p), p = ceil(units / splits); the splits' partials are added in
    split order."""
    n, hgt, wid, ch = h_prev.shape
    a = taps(h_prev).transpose(0, 2, 1).reshape(9 * ch, -1)  # [(tap, c), pixels]
    b = dg.reshape(-1, dg.shape[-1])
    units = list(dw_units(n, 1, hgt, wid))
    per = -(-len(units) // splits)
    out = np.zeros((9 * ch, b.shape[1]), np.float32)
    for z in range(splits):
        acc = np.zeros_like(out)
        for steps in units[z * per:(z + 1) * per]:
            for pix in steps:
                acc = f32(acc + f32(a[:, pix].astype(np.float64) @ b[pix].astype(np.float64)))
        out = f32(out + acc)
    return out


def plan_of(shape):
    b, t, h, w, c = shape
    return recurrence_plan("convlstm_backward", b, t, h, w, c, BF16, "stepwise_tc")


def emulate_backward(gx, wh, h0, c0, h_seq, c_seq, dh_seq, dhf, dcf):
    """Kernel 3 in bf16 stepwise_tc, the plan's clusters and splits.
    ``gx``, ``wh``, ``h_seq``, ``c_seq``, ``dh_seq`` bf16 values; ``h0``,
    ``c0``, ``dhf``, ``dcf`` f32.  Returns (dgates_x in bf16 values, dWh
    [3,3,C,4C], dh0, dc0) in f32."""
    b, t_len, hgt, wid, four_c = gx.shape
    ch = four_c // 4
    plan = plan_of((b, t_len, hgt, wid, ch))
    whb = torch.from_numpy(wh).to(BF16)
    fwd = tc_stage_images(whb, "fwd").float().numpy()
    bwd = tc_stage_images(whb, "bwd").float().numpy()
    # the gate recompute over every frame: h_{t-1} is bf16 h0 at t = 0
    h_prev = np.concatenate([bf16(h0)[:, None], h_seq[:, :-1]], 1).reshape(-1, hgt, wid, ch)
    conv = tile_sum(taps(h_prev), fwd, plan.gate_groups)  # columns (tile, gate, channel)
    cols = np.arange(-(-ch // 16) * 64)
    chan = 16 * (cols // 64) + cols % 16
    keep = chan < ch
    gates = np.zeros((conv.shape[0], four_c), np.float32)
    gates[:, (cols[keep] % 64) // 16 * ch + chan[keep]] = conv[:, keep]
    act = (gx.reshape(-1, four_c) + gates).reshape(gx.shape)
    act = np.concatenate([sigmoid(act[..., :2 * ch]), tanh(act[..., 2 * ch:3 * ch]),
                          sigmoid(act[..., 3 * ch:])], -1)
    dgates = np.zeros_like(gx)
    dh, dc = bf16(dhf), bf16(dcf)  # the wrapper seeds the carries as _bwd casts them

    def dh_product(dg_t):
        return tile_sum(taps(dg_t, reverse=True), bwd, plan.cluster)[:, :ch].reshape(dh.shape)

    for t in reversed(range(t_len)):
        if t < t_len - 1:
            dh = dh_product(dgates[:, t + 1])
        i, f, g, o = (act[:, t, ..., j * ch:(j + 1) * ch] for j in range(4))
        tanh_ct = tanh(c_seq[:, t])
        c_prev = c0 if t == 0 else c_seq[:, t - 1]
        dh_total = f32(dh_seq[:, t] + dh)
        dc_total = f32(dc + dh_total * o * (1.0 - tanh_ct * tanh_ct))
        dgates[:, t] = bf16(np.concatenate([dc_total * g * i * (1.0 - i),
                                            dc_total * c_prev * f * (1.0 - f),
                                            dc_total * i * (1.0 - g * g),
                                            dh_total * tanh_ct * o * (1.0 - o)], -1))
        dc = f32(dc_total * f)
    dw = emulate_dw(h_prev, dgates.reshape(-1, hgt, wid, four_c), plan.dw_splits)
    return dgates, dw.reshape(3, 3, ch, four_c), dh_product(dgates[:, 0]), dc


# ------------------------------------------------------------- references


def inputs(shape, seed):
    """Kernel 3's inputs: the forward's bf16 h_seq and c_seq from the port's
    plain forward (what kernel 2 stores), random cotangents."""
    b, t, h, w, c = shape
    rng = np.random.default_rng(seed)
    gx = bf16(rng.normal(size=(b, t, h, w, 4 * c)) * 0.5)
    wh = bf16(rng.normal(size=(3, 3, c, 4 * c)) * (0.3 / np.sqrt(c)))
    h0 = f32(rng.normal(size=(b, h, w, c)) * 0.3)
    c0 = f32(rng.normal(size=(b, h, w, c)) * 0.3)
    dhs = bf16(rng.normal(size=(b, t, h, w, c)))
    dhf, dcf = f32(rng.normal(size=(b, h, w, c))), f32(rng.normal(size=(b, h, w, c)))
    tx = [torch.from_numpy(a) for a in (gx, wh, h0, c0)]
    hs, cs, _ = convlstm.convlstm_forward_ref(tx[0].to(BF16), tx[1].to(BF16), tx[2], tx[3],
                                              with_cell_seq=True)
    return gx, wh, h0, c0, hs.float().numpy(), cs.float().numpy(), dhs, dhf, dcf


def jax_vjp(gx, wh, h0, c0, dhs, dhf, dcf, pallas: bool):
    """JAX's (dgates_x, dWh, dh0, dc0) in bf16 (gates and weights bf16, (h,
    c) f32): the custom VJP of ``convlstm_recurrence_pallas`` (``_bwd`` ->
    ``_run_backward``) with its kernels in interpret mode, or the VJP of
    the plain scan of ``convlstm_step``; plus (with ``pallas``) JAX's own
    forward sequences, kernel 3's inputs there."""
    x = (jnp.asarray(gx, jnp.bfloat16), jnp.asarray(wh, jnp.bfloat16), jnp.asarray(h0),
         jnp.asarray(c0))
    cot = (jnp.asarray(dhs, jnp.bfloat16), (jnp.asarray(dhf), jnp.asarray(dcf)))
    if pallas:
        real = convlstm_pallas.pl.pallas_call
        convlstm_pallas.pl.pallas_call = functools.partial(real, interpret=True)
        try:
            _, vjp = jax.vjp(convlstm_recurrence_pallas, *x)
            grads = vjp(cot)
            hs, cs, _, _ = convlstm_pallas._run_forward(*x, with_cell_seq=True)
        finally:
            convlstm_pallas.pl.pallas_call = real
        seqs = (np.asarray(hs, np.float32), np.asarray(cs, np.float32))
    else:
        def scan(gx_, wh_, h0_, c0_):
            def step(carry, g_t):
                h, c = jax_convlstm_step(g_t, *carry, wh_)
                return (h, c), h.astype(gx_.dtype)

            (hf, cf), hs = jax.lax.scan(step, (h0_, c0_), jnp.moveaxis(gx_, 1, 0))
            return jnp.moveaxis(hs, 0, 1), (hf, cf)

        _, vjp = jax.vjp(scan, *x)
        grads = vjp(cot)
        seqs = None
    return [np.asarray(g, np.float32) for g in grads], seqs


def agree(got, want, is_sum: bool = False) -> bool:
    """chip_smoke.py's bf16 rule: allclose at ``BF16_BAR`` (dWh's atol x
    max(1, max |want|)) and rel L2 within the rtol."""
    got, want = f32(got), f32(want)
    atol = BF16_BAR["atol"] * (max(1.0, float(np.abs(want).max())) if is_sum else 1.0)
    rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    close = bool(np.allclose(got, want, rtol=BF16_BAR["rtol"], atol=atol))
    return close and rel <= BF16_BAR["rtol"]


def plain(args):
    """The port's plain kernel 3 (``convlstm_backward_ref``) on the CPU."""
    gx, wh, h0, c0, hs, cs, dhs, dhf, dcf = (torch.from_numpy(np.ascontiguousarray(a))
                                             for a in args)
    out = convlstm.convlstm_backward_ref(gx.to(BF16), wh.to(BF16), h0, c0, hs.to(BF16),
                                         cs.to(BF16), dhs.to(BF16), dhf, dcf)
    return [o.float().numpy() for o in out]


# ------------------------------------------------------------------ tests


@pytest.fixture(scope="module")
def pallas_case():
    """The C=128 case: JAX's forward sequences (Pallas, interpret mode) as
    kernel 3's inputs, JAX's VJP, the port's plain kernel 3 and the
    emulation, computed once."""
    gx, wh, h0, c0, _, _, dhs, dhf, dcf = inputs(PALLAS, seed=11)
    grads, (hs, cs) = jax_vjp(gx, wh, h0, c0, dhs, dhf, dcf, pallas=True)
    args = (gx, wh, h0, c0, hs, cs, dhs, dhf, dcf)
    return grads, plain(args), emulate_backward(*args)


@pytest.mark.parametrize("name", NAMES)
def test_emulation_matches_jax_pallas_backward(pallas_case, name):
    """At C=128 on 8x40: the emulated bf16 tile sums against JAX's
    ``_run_backward`` (its custom VJP, interpret mode) at the bf16 bar."""
    jax_grads, _, got = pallas_case
    i = NAMES.index(name)
    assert agree(got[i], jax_grads[i], is_sum=name == "dw_h"), name


@pytest.mark.parametrize("name", NAMES)
def test_emulation_matches_plain_at_c128(pallas_case, name):
    """The same emulation against the port's ``convlstm_backward_ref``."""
    _, ref, got = pallas_case
    i = NAMES.index(name)
    assert agree(got[i], ref[i], is_sum=name == "dw_h"), name


@pytest.mark.parametrize("shape", SMALL, ids=lambda s: "x".join(map(str, s)))
def test_emulation_matches_jax_and_plain(shape):
    """C=16 on 24x24 and C=24 on 8x40: the emulation against JAX's plain
    scan VJP and against ``convlstm_backward_ref`` at the bf16 bar."""
    args = inputs(shape, seed=sum(shape))
    gx, wh, h0, c0, _, _, dhs, dhf, dcf = args
    want, _ = jax_vjp(gx, wh, h0, c0, dhs, dhf, dcf, pallas=False)
    got = emulate_backward(*args)
    ref = plain(args)
    for name, g, w, r in zip(NAMES, got, want, ref):
        assert agree(g, w, is_sum=name == "dw_h"), f"{name} vs JAX"
        assert agree(g, r, is_sum=name == "dw_h"), f"{name} vs plain"


def test_dh_product_reads_reversed_taps():
    """A Wh zero but for one entry Wh[tap][c][n] moves dh only at channel c,
    through the reversed tap: dgates at one pixel p feed dh at p + (dy - 1,
    dx - 1), as the correlation with Wh's taps reversed does."""
    b, h, w, c = 1, 8, 40, 24
    dg = np.zeros((b, h, w, 4 * c), np.float32)
    dg[0, 3, 17, 50] = 1.0  # gate column 50: gate 2, channel 2
    for tap, chan in ((4, 5), (0, 23), (8, 16), (5, 0)):
        wh = np.zeros((3, 3, c, 4 * c), np.float32)
        wh[tap // 3, tap % 3, chan, 50] = 0.5
        images = tc_stage_images(torch.from_numpy(wh).to(BF16), "bwd").float().numpy()
        for ranks in (1, 2, 4):
            dh = tile_sum(taps(dg, reverse=True), images, ranks)
            hit = np.argwhere(dh != 0)
            dy, dx = tap // 3 - 1, tap % 3 - 1
            assert hit.tolist() == [[(3 + dy) * w + 17 + dx, chan]]
            assert dh[hit[0][0], hit[0][1]] == 0.5


def test_bwd_stage_images_bit_for_bit():
    """``tc_stage_images`` of a bf16 Wh in kernel 3's layout: tile t, chunk
    kc, tap, group g, row n, value e holds Wh[tap][64 t + n][16 kc + 8 g +
    e] bit for bit, zeros past C; 18,432 bytes a stage; no split."""
    c = 72
    wh = torch.from_numpy(np.random.default_rng(5).normal(size=(3, 3, c, 4 * c)).astype(
        np.float32)).to(BF16)
    img = tc_stage_images(wh, "bwd")
    assert img.dtype == BF16 and img.shape == (2, 18, 9, 2, 64, 8)
    assert img[0, 0].numel() * 2 == 18_432 == convlstm._TC_STAGE_B_BF16
    w9 = wh.reshape(9, c, 4 * c).view(torch.int16).numpy()
    t, kc, tap, g, n, e = np.meshgrid(*(np.arange(d) for d in img.shape), indexing="ij")
    chan, col = 64 * t + n, 16 * kc + 8 * g + e
    want = np.where(chan < c, w9[tap, np.minimum(chan, c - 1), col], 0)
    np.testing.assert_array_equal(img.contiguous().view(torch.int16).numpy(), want)
    # the cache serves it per weight state and layout, as in f32
    assert convlstm._tc_weights(wh, "bwd") is convlstm._tc_weights(wh, "bwd")


@pytest.mark.parametrize("wid", (8, 24, 32, 40, 70, 100))
def test_dw_units_cover_every_pixel_once(wid):
    """dWh's units (R rows x SW columns) and their 16-pixel K steps visit
    every pixel of every frame exactly once, whatever W; the plan counts
    the same units, and the staging ring fits a block's shared memory."""
    b, t, hgt = 2, 3, 11
    seen = np.zeros(b * t * hgt * wid, np.int64)
    units = list(dw_units(b, t, hgt, wid))
    for steps in units:
        for pix in steps:
            assert 1 <= len(pix) <= 16
            seen[pix] += 1
    assert (seen == 1).all()
    rows, seg = convlstm._tc_dw_run(wid)
    assert seg % 16 == 0 and seg <= 64 and rows == 128 // seg and rows * seg <= 128
    assert len(units) == b * t * -(-hgt // rows) * -(-wid // seg)
    for ch in (16, 64, 128):
        assert convlstm._tc_dw_smem(wid, ch) <= convlstm.SMEM_LIMIT


def test_dw_split_order_sum_is_fixed():
    """dWh's splits added in split order give one set of bits however often
    the sum is taken, and any split count lies within f32 rounding of the
    float64 product."""
    rng = np.random.default_rng(8)
    h_prev = bf16(rng.normal(size=(4, 5, 24, 8)) * 0.3)
    dg = bf16(rng.normal(size=(4, 5, 24, 32)))
    one = emulate_dw(h_prev, dg, 3)
    assert np.array_equal(one, emulate_dw(h_prev, dg, 3))
    exact = (taps(h_prev).transpose(0, 2, 1).reshape(72, -1).astype(np.float64)
             @ dg.reshape(-1, 32).astype(np.float64))
    for splits in (1, 3, 5):
        np.testing.assert_allclose(emulate_dw(h_prev, dg, splits), exact, rtol=1e-5, atol=1e-4)


def test_plan_at_512_bf16():
    """A 32x32 latent at B=8, T=16, C=128 in bf16: kernel 3 on stepwise_tc,
    T + 3 launches; the reverse loop on 64 x 2 tiles of 128 pixels in
    clusters of 2 (256 blocks a step), the gate recompute on 1,024 x 8
    tiles, dWh on 24 blocks (3 tap rows x 8 column tiles, 128 input
    channels) x 11 splits, the last launch on the loop's grid plus 72 z
    planes of split-sum clusters; Wh's bf16 stage images 2,359,296 bytes."""
    plan = recurrence_plan("convlstm_backward", 8, 16, 32, 32, 128, BF16)
    assert (plan.design, plan.launches, plan.cluster, plan.warpgroups) == (
        "stepwise_tc", 19, 2, 2)
    assert plan.grids["step"] == (2, 2, 64) and plan.step_blocks == 256
    assert plan.grids["gate"] == (1, 8, 1024) and plan.gate_warpgroups == 2
    assert plan.grids["dw"] == (24, 11) and plan.dw_splits == 11
    assert plan.grids["finish"] == (2, 2, 64 + 72)
    assert plan.weight_bytes == (2 * 32 + 8 * 8) * 18_432 == 2_359_296
    assert plan.smem_bytes == convlstm._tc_dw_smem(32, 128) <= convlstm.SMEM_LIMIT
    act = 8 * 16 * 32 * 32 * 512 * 4  # the f32 gate activations, 268 MB
    assert plan.scratch_bytes == act + 11 * 9 * 128 * 512 * 4
    forced = recurrence_plan("convlstm_backward", 8, 16, 32, 32, 128, BF16, design="stepwise")
    assert (forced.design, forced.launches) == ("stepwise", 19)


def test_plan_keeps_256_resident_and_f32():
    """The 256² bf16 training shape stays resident (its tile only when
    named), f32 stays stepwise_tc on its 3xTF32 grids, and a C that is no
    multiple of 8 keeps bf16 kernel 3 stepwise."""
    assert recurrence_plan("convlstm_backward", 8, 16, 16, 16, 128, BF16).design == "resident"
    named = recurrence_plan("convlstm_backward", 8, 16, 16, 16, 128, BF16, "stepwise_tc")
    assert named.grids["step"] == (8, 2, 16) and named.grids["dw"] == (24, 11)
    f32_plan = recurrence_plan("convlstm_backward", 8, 16, 32, 32, 128, torch.float32)
    assert f32_plan.design == "stepwise_tc" and len(f32_plan.grids["dw"]) == 3
    assert recurrence_plan("convlstm_backward", 2, 3, 24, 24, 20, BF16).design == "stepwise"
    assert tc_fits(16, BF16, 24) and not tc_fits(20, BF16, 24)


def test_train_fps_needs_a_card():
    """``scorer_fps.py --train`` (the 512² bf16 train step's frames/s, two
    trees in one call) refuses to run without a card, before building
    anything."""
    from vad_tpu_torch.tools import scorer_fps

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            scorer_fps.main(["--image-size", "32", "--train"])


def test_tc_variants_backward_patches_apply():
    """``python -m vad_tpu_torch.tools.tc_variants --backward`` builds kernel
    3's bf16 form in variants by text patches of the sources: each patch
    must still find its text (the built variant changes nothing), and
    without a card the tool refuses to run."""
    from vad_tpu_torch.ops import _build
    from vad_tpu_torch.tools import tc_variants

    csrc = _build.CSRC_DIR
    for name, patch in tc_variants.BWD_VARIANTS.items():
        src = {f.name: f.read_text() for f in (*csrc.glob("*.cuh"), csrc / tc_variants.BACKWARD)}
        before = dict(src)
        patch(src)
        assert (src != before) == (name != "built"), name
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            tc_variants.main(["--backward"])
