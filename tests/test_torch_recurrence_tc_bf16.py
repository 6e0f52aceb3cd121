"""The bf16 form of the stepwise_tc design (kernels 1 and 2), checked on the CPU.

In bf16 the stepwise_tc tile (``vad_tpu_torch/csrc/convlstm_tiles.cuh``,
the ``tc`` step of ``convlstm_serving.cu``) takes kernels 1 and 2 wherever
the resident design refuses the frame: a 32x32 latent of 512x512 streams,
and kernel 1's row form.  A K stage is one 16-channel chunk of h_{t-1} at
all 9 taps, read as halo rows around the block's pixel tile; each tap is
one wgmma m64n64k16 (bf16 in, f32 accumulate) against the stage's B image,
Wh laid out by ``tc_stage_images`` ([column tile][chunk][tap][2 groups of
8][64 rows][8]); a cluster splits the chunks, its partial tiles summed in
rank order.  The kernel runs only on the card (chip_smoke.py holds it
against the plain versions there); these tests emulate its sums in numpy,
reading A through the kernel's halo rules and B through the stage images by
its index rule, and hold the emulation against the JAX package (its plain
scan at small widths, ``convlstm_recurrence_pallas`` in interpret mode at
C=128) at the bf16 bar and against the port's plain recurrence within rel
L2 1e-2.  The row form's halo rule (rows -1 and Hs of a shard's tile are
its neighbours' boundary rows) must give the unsplit emulation's bits.
Also the layout itself and the plan's choices.

Bar: bf16 rtol 0.05 / atol 0.02 (the repo's bf16 policy bar).
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
KC = 16  # a bf16 K chunk: 16 channels at all 9 taps
# (B, T, H, W, C): C of one chunk, two, and a half-empty second chunk;
# frames 8x8 and 16x8; and C=128 for JAX's Pallas kernel
SMALL = ((2, 3, 8, 8, 8), (2, 3, 16, 8, 16), (1, 2, 16, 8, 24))
PALLAS = (1, 2, 8, 8, 128)


def bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16 (to nearest, ties to even), as f32 values."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(BF16).float().numpy()


def sigmoid(x):
    return (1.0 / (1.0 + np.exp(-x.astype(np.float64)))).astype(np.float32)


def tanh(x):
    return np.tanh(x.astype(np.float64)).astype(np.float32)


def b_tile(images: np.ndarray, nt: int, kc: int, tap: int) -> np.ndarray:
    """B of (column tile nt, chunk kc, tap) as the kernel's wgmma reads the
    stage image: K-major core matrices, element (k, n) at [k // 8][n][k %
    8] -> ``[16 (K), 64 (N)]``."""
    return images[nt, kc, tap].transpose(0, 2, 1).reshape(KC, 64)


def emulate_conv(h_prev, images, nw, ranks, halo=None):
    """The hidden conv of one step as the bf16 stepwise_tc kernel sums it:
    ``h_prev [B, H, W, C]`` (bf16 values) -> ``[B*H*W, 4C]`` f32.

    Pixel tiles of ``64 nw`` rows run over the batch's raster order, or
    (``halo`` = (top, bottom): the row form, each ``[B, W, C]`` or None at
    the frame's edge) within each frame.  A tile's halo rows follow the
    kernel's ``a_src``, each fragment row's tap its ``hrow``; per chunk and
    tap one product (exact in float64, rounded to f32) is added to the
    rank's f32 sum, the chunks split over ``ranks`` as a cluster splits
    them and the ranks' sums added in rank order.  Column n of tile nt is
    gate n // 16 of channel 16 nt + n % 16."""
    b, hgt, wid, ch = h_prev.shape
    hw, m_rows = hgt * wid, 64 * nw
    chunks, n_tiles = -(-ch // KC), -(-ch // 16)
    flat = np.zeros((b * hw, chunks * KC), np.float32)
    flat[:, :ch] = h_prev.reshape(b * hw, ch)
    if halo is None:
        tiles = [(0, z * m_rows, b * hw) for z in range(-(-b * hw // m_rows))]
    else:
        per_b = -(-hw // m_rows)
        tiles = [(tb, tb * hw + j * m_rows, (tb + 1) * hw) for tb in range(b)
                 for j in range(per_b)]
    out = np.zeros((b * hw, 4 * ch), np.float32)
    for tb, m0, end in tiles:
        rows = np.zeros((m_rows + 2 * wid + 2, chunks * KC), np.float32)
        for row in range(len(rows)):
            m = m0 - (wid + 1) + row
            if halo is None:
                if 0 <= m < b * hw:
                    rows[row] = flat[m]
                continue
            e = m - tb * hw + wid  # rows -1 .. Hs of frame tb
            if not 0 <= e < (hgt + 2) * wid:
                continue
            y, x = e // wid - 1, e % wid
            side = halo[0] if y < 0 else halo[1] if y >= hgt else None
            if y < 0 or y >= hgt:
                if side is not None:
                    rows[row, :ch] = side[tb, x]
            else:
                rows[row] = flat[tb * hw + y * wid + x]
        r = np.arange(m_rows)
        m = m0 + r
        p = m % hw
        taps = []
        for tap in range(9):
            dy, dx = tap // 3 - 1, tap % 3 - 1
            y, x = p // wid + dy, p % wid + dx
            ok = (m < end) & (x >= 0) & (x < wid)
            if halo is None:
                ok &= (y >= 0) & (y < hgt)
            idx = np.clip(r + wid + 1 + dy * wid + dx, 0, len(rows) - 1)
            taps.append(np.where(ok[:, None], rows[idx], 0.0).astype(np.float32))
        keep = m < end
        for nt in range(n_tiles):
            total = np.zeros((m_rows, 64), np.float32)
            for rank in range(ranks):
                acc = np.zeros((m_rows, 64), np.float32)
                for kc in range(rank * chunks // ranks, (rank + 1) * chunks // ranks):
                    for tap in range(9):
                        part = (taps[tap][:, kc * KC:(kc + 1) * KC].astype(np.float64)
                                @ b_tile(images, nt, kc, tap).astype(np.float64))
                        acc = (acc + part.astype(np.float32)).astype(np.float32)
                total = (total + acc).astype(np.float32)
            for n in range(64):
                chan = 16 * nt + n % 16
                if chan < ch:
                    out[m[keep], n // 16 * ch + chan] = total[keep, n]
    return out


def lstm_epilogue(gx_t, conv, c):
    """The kernel's gate epilogue: f32 gates, c in f32, h_seq in bf16 (the
    activations exact here; the kernel's hardware tanh is within 2^-10.9 of
    them, far inside bf16's 2^-8)."""
    ch = c.shape[-1]
    gates = gx_t.reshape(-1, 4 * ch) + conv
    i, f, g, o = (gates[:, j * ch:(j + 1) * ch] for j in range(4))
    c_new = (sigmoid(f) * c.reshape(-1, ch) + sigmoid(i) * tanh(g)).astype(np.float32)
    h_new = (sigmoid(o) * tanh(c_new)).astype(np.float32)
    return h_new.reshape(c.shape), c_new.reshape(c.shape)


def plan_of(shape, shards=1):
    """Kernel 1's bf16 stepwise_tc plan (named: small frames are resident's)."""
    b, t, h, w, c = shape
    return recurrence_plan("convlstm_serving", b, t, h, w, c, BF16, "stepwise_tc", shards=shards)


def emulate_forward(gx, wh, h0, c0, ranks=None):
    """Kernels 1-2 in bf16 stepwise_tc (the plan's tiles and K split, or
    ``ranks`` blocks a cluster).  ``gx``, ``wh`` bf16 values; ``h0``, ``c0``
    f32.  Returns (h_seq in bf16 values, c_seq, h_T, c_T) in f32."""
    plan = plan_of(gx.shape[:4] + (gx.shape[4] // 4,))
    images = stage_images(wh)
    h_in, c = bf16(h0), c0
    hs, cs = [], []
    for t in range(gx.shape[1]):
        conv = emulate_conv(h_in, images, plan.warpgroups, ranks or plan.cluster)
        h, c = lstm_epilogue(gx[:, t], conv, c)
        h_in = bf16(h)  # h_seq[:, t]: the next step's input
        hs.append(h_in)
        cs.append(c)
    return np.stack(hs, 1), np.stack(cs, 1), h, c


def emulate_rows(gx, wh, h0, c0, shards, ranks=None):
    """Kernel 1's row form in bf16 stepwise_tc over ``shards`` row shards in
    lockstep: each step, shard i's tiles read shard i-1's last row and shard
    i+1's first row of h_{t-1} (none at the frame's edge).  Returns the
    shards' (h_seq, h_T, c_T) joined along H."""
    b, t_len, hgt, wid, four_c = gx.shape
    ch, rows = four_c // 4, hgt // shards
    plan = plan_of((b, t_len, hgt, wid, ch), shards)
    images = stage_images(wh)
    h_in = [bf16(h0[:, i * rows:(i + 1) * rows]) for i in range(shards)]
    c = [c0[:, i * rows:(i + 1) * rows] for i in range(shards)]
    h = [None] * shards
    seqs = [[] for _ in range(shards)]
    for t in range(t_len):
        new_in = []
        for i in range(shards):
            top = h_in[i - 1][:, -1] if i > 0 else None
            bot = h_in[i + 1][:, 0] if i < shards - 1 else None
            conv = emulate_conv(h_in[i], images, plan.warpgroups, ranks or plan.cluster,
                                halo=(top, bot))
            h[i], c[i] = lstm_epilogue(gx[:, t, i * rows:(i + 1) * rows], conv, c[i])
            new_in.append(bf16(h[i]))
            seqs[i].append(new_in[-1])
        h_in = new_in
    return (np.concatenate([np.stack(s, 1) for s in seqs], 2), np.concatenate(h, 1),
            np.concatenate(c, 1))


def stage_images(wh: np.ndarray) -> np.ndarray:
    """The wrapper's bf16 stage images of ``wh``, as f32 values."""
    return tc_stage_images(torch.from_numpy(wh).to(BF16), "fwd").float().numpy()


def inputs(shape, seed):
    b, t, h, w, c = shape
    rng = np.random.default_rng(seed)
    gx = bf16(rng.normal(size=(b, t, h, w, 4 * c)) * 0.5)
    wh = bf16(rng.normal(size=(3, 3, c, 4 * c)) * (0.3 / np.sqrt(c)))
    h0 = (rng.normal(size=(b, h, w, c)) * 0.3).astype(np.float32)
    c0 = (rng.normal(size=(b, h, w, c)) * 0.3).astype(np.float32)
    return gx, wh, h0, c0


def jax_forward(gx, wh, h0, c0, pallas: bool):
    """(h_seq, h_T, c_T) of the JAX package in bf16 (gates and weights bf16,
    (h, c) carried in f32): ``convlstm_recurrence_pallas`` in interpret
    mode, or the plain scan of ``convlstm_step``."""
    x = (jnp.asarray(gx, jnp.bfloat16), jnp.asarray(wh, jnp.bfloat16), jnp.asarray(h0),
         jnp.asarray(c0))
    if pallas:
        real = convlstm_pallas.pl.pallas_call
        convlstm_pallas.pl.pallas_call = functools.partial(real, interpret=True)
        try:
            hs, (hf, cf) = convlstm_recurrence_pallas(*x)
        finally:
            convlstm_pallas.pl.pallas_call = real
    else:
        def step(carry, g_t):
            h, c = jax_convlstm_step(g_t, *carry, x[1])
            return (h, c), h

        (hf, cf), hs = jax.lax.scan(step, (x[2], x[3]), jnp.moveaxis(x[0], 1, 0))
        hs = jnp.moveaxis(hs, 0, 1)
    return [np.asarray(v, np.float32) for v in (hs, hf, cf)]


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("shape", (*SMALL, PALLAS), ids=lambda s: "x".join(map(str, s)))
def test_emulation_matches_jax_and_plain(shape):
    """The bf16 tile's sums, emulated, against JAX (Pallas at C=128, else
    its plain scan) at the bf16 bar and against the port's plain
    recurrence within rel L2 1e-2."""
    gx, wh, h0, c0 = inputs(shape, seed=sum(shape))
    hs, _, hf, cf = emulate_forward(gx, wh, h0, c0)
    want = jax_forward(gx, wh, h0, c0, pallas=shape == PALLAS)
    for name, got, ref in zip(("h_seq", "h_T", "c_T"), (hs, hf, cf), want):
        np.testing.assert_allclose(got, ref, **BF16_BAR, err_msg=name)
    t = [torch.from_numpy(a) for a in (gx, wh, h0, c0)]
    ref_seq, (ref_h, ref_c) = convlstm.convlstm_recurrence_ref(t[0].to(BF16), t[1].to(BF16),
                                                               t[2], t[3])
    for name, got, ref in zip(("h_seq", "h_T", "c_T"), (hs, hf, cf),
                              (ref_seq.float(), ref_h, ref_c)):
        assert rel_l2(got, ref.numpy()) <= 1e-2, name


def test_emulation_reads_every_weight():
    """A Wh that is zero but for one entry moves only the gate column it
    feeds, through the tap it sits at: the stage images' index rule maps
    each weight to its (tap, input channel, gate column)."""
    shape = (1, 1, 8, 8, 24)
    b, _, h, w, c = shape
    h0 = np.zeros((b, h, w, c), np.float32)
    h0[0, 3, 4, 17] = 1.0  # one pixel, one input channel
    for tap, gate, chan in ((4, 2, 5), (0, 3, 23), (8, 0, 16)):
        wh = np.zeros((3, 3, c, 4 * c), np.float32)
        wh[tap // 3, tap % 3, 17, gate * c + chan] = 0.5
        conv = emulate_conv(bf16(h0), stage_images(wh), 1, 1)
        hit = np.argwhere(conv != 0)
        dy, dx = tap // 3 - 1, tap % 3 - 1  # the output pixel whose tap reads (3, 4)
        assert hit.tolist() == [[(3 - dy) * w + 4 - dx, gate * c + chan]]
        assert conv[hit[0][0], hit[0][1]] == 0.5


def test_bf16_stage_images_bit_for_bit():
    """``tc_stage_images`` of a bf16 Wh: tile t, chunk kc, tap, group g, row
    n, value e holds Wh[tap][16 kc + 8 g + e][gate n // 16, channel 16 t +
    n % 16] bit for bit, zeros past C; 18,432 bytes a stage; no split."""
    c = 24
    wh = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 3, c, 4 * c)).astype(
        np.float32)).to(BF16)
    img = tc_stage_images(wh, "fwd")
    assert img.dtype == BF16 and img.shape == (2, 2, 9, 2, 64, 8)
    assert img[0, 0].numel() * 2 == 18_432 == convlstm._TC_STAGE_B_BF16
    w9 = wh.reshape(9, c, 4 * c).view(torch.int16).numpy()
    t, kc, tap, g, n, e = np.meshgrid(*(np.arange(d) for d in img.shape), indexing="ij")
    chan, cin = 16 * t + n % 16, 16 * kc + 8 * g + e
    ok = (chan < c) & (cin < c)
    want = np.where(ok, w9[tap, np.minimum(cin, c - 1), n // 16 * c + np.minimum(chan, c - 1)], 0)
    np.testing.assert_array_equal(img.contiguous().view(torch.int16).numpy(), want)
    assert tc_stage_images(wh, "bwd").shape == (1, 6, 9, 2, 64, 8)  # kernel 3's (PR 17)


@pytest.mark.parametrize("shards", (2, 4))
@pytest.mark.parametrize("shape", SMALL[1:], ids=lambda s: "x".join(map(str, s)))
def test_row_form_halo_rule_equals_unsplit(shape, shards):
    """Kernel 1's row form, emulated over row shards in lockstep with the
    neighbours' boundary rows as rows -1 and Hs of each tile, gives the
    unsplit emulation's bits at the same K split, and stays within the
    bf16 bar of it at the plans' own splits."""
    gx, wh, h0, c0 = inputs(shape, seed=7 * shards)
    for ranks in (1, 2):
        hs, _, hf, cf = emulate_forward(gx, wh, h0, c0, ranks=ranks)
        split = emulate_rows(gx, wh, h0, c0, shards, ranks=ranks)
        for got, want in zip(split, (hs, hf, cf)):
            np.testing.assert_array_equal(got, want)
    whole = emulate_forward(gx, wh, h0, c0)
    for got, want in zip(emulate_rows(gx, wh, h0, c0, shards), (whole[0], *whole[2:])):
        np.testing.assert_allclose(got, want, **BF16_BAR)


@pytest.mark.parametrize("shape", ((16, 16, 32, 32, 128), (8, 16, 32, 32, 128),
                                   (1, 16, 32, 32, 128)), ids=("S16", "B8", "B1"))
def test_plan_takes_stepwise_tc_at_512(shape):
    """A 32x32 latent (512x512 streams) in bf16: kernels 1 and 2 on the bf16
    tile (1,024 blocks a step at S=16: 128 x 8 tiles of 128 pixels; 512 at
    B=8; clusters of 4 at B=1 for 256), and kernel 3 on it too (since PR
    17), with T + 3 launches."""
    grids = {16: (1, 8, 128), 8: (1, 8, 64), 1: (4, 8, 8)}
    for kernel in ("convlstm_serving", "convlstm_train_forward"):
        plan = recurrence_plan(kernel, *shape, BF16)
        assert (plan.design, plan.launches, plan.warpgroups) == ("stepwise_tc", 16, 2)
        assert plan.grids["step"] == grids[shape[0]] and plan.cluster == grids[shape[0]][0]
        assert plan.weight_bytes == 8 * 8 * 18_432 and plan.smem_bytes <= convlstm.SMEM_LIMIT
        assert recurrence_plan(kernel, *shape, BF16, design="stepwise").design == "stepwise"
    back = recurrence_plan("convlstm_backward", *shape, BF16)
    assert (back.design, back.launches) == ("stepwise_tc", shape[1] + 3)


def test_plan_keeps_the_other_choices():
    """16x16 at S=16 stays resident in bf16 (and stepwise_tc in f32); a
    ragged C (not a multiple of 8) stays stepwise; naming the bf16 tile at
    16x16 runs it; kernel 3's bf16 takes it wherever kernels 1-2's does
    (since PR 17), named at 16x16 too."""
    serving = (16, 16, 16, 16, 128)
    for kernel in ("convlstm_serving", "convlstm_train_forward", "convlstm_backward"):
        assert recurrence_plan(kernel, *serving, BF16).design == "resident"
        assert recurrence_plan(kernel, *serving, torch.float32).design == "stepwise_tc"
        assert recurrence_plan(kernel, 2, 3, 32, 32, 20, BF16).design == "stepwise"
    forced = recurrence_plan("convlstm_serving", *serving, BF16, design="stepwise_tc")
    assert forced.grids["step"] == (1, 8, 32) and forced.launches == 16
    assert tc_fits(24, BF16, 32) and not tc_fits(20, BF16, 32)
    back = recurrence_plan("convlstm_backward", 8, 16, 16, 16, 128, BF16, design="stepwise_tc")
    assert back.grids["step"] == (8, 2, 16) and back.launches == 19
    with pytest.raises(ValueError, match="stepwise_tc design does not take"):
        recurrence_plan("convlstm_backward", 8, 16, 32, 32, 20, BF16, design="stepwise_tc")


def test_cpu_row_wrapper_names_a_design():
    """``convlstm_recurrence_rows(..., design=...)`` on CPU tensors runs the
    plain version whatever the design; on the card the plan refuses a
    design that does not fit before anything launches."""
    b, t, h, w, c = 1, 2, 8, 8, 16
    gx, wh, h0, c0 = (torch.from_numpy(a) for a in inputs((b, t, h, w, c), seed=3))
    args = (list(gx.to(BF16).split(4, 2)), wh.to(BF16), list(h0.split(4, 1)),
            list(c0.split(4, 1)))
    seqs, _ = convlstm.convlstm_recurrence_rows(*args, design="stepwise")
    want, _ = convlstm.convlstm_recurrence_ref(gx.to(BF16), wh.to(BF16), h0, c0)
    torch.testing.assert_close(torch.cat(seqs, 2), want)
    with pytest.raises(ValueError, match="stepwise_tc design does not take the row form"):
        recurrence_plan("convlstm_serving", b, t, h, w, 20, BF16, "stepwise_tc", shards=2)


def test_tc_variants_patches_apply():
    """``python -m vad_tpu_torch.tools.tc_variants`` builds the bf16 step in
    variants by text patches of the sources: each patch must still find its
    text (the built variant changes nothing), and without a card the tool
    refuses to run."""
    from vad_tpu_torch.ops import _build
    from vad_tpu_torch.tools import tc_variants

    csrc = _build.CSRC_DIR
    for name, patch in tc_variants.VARIANTS.items():
        src = {f.name: f.read_text() for f in (*csrc.glob("*.cuh"), csrc / tc_variants.SERVING)}
        before = dict(src)
        patch(src)
        assert (src != before) == (name != "built"), name
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            tc_variants.main()


def test_scorer_fps_needs_a_card():
    from vad_tpu_torch.tools import scorer_fps

    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            scorer_fps.main(["--image-size", "32"])
