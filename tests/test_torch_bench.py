"""The port's benchmark (``python -m vad_tpu_torch.bench``) against the JAX
package's ``bench.py``, on the CPU at small sizes.

- The FLOP counts and the source frames equal the JAX bench's exactly.
- Each scoring step form (fused, kernel, plain) at S=2, T=4, 32², latent
  and hidden 16, one ConvLSTM layer, chained over 2 chunks, matches the
  JAX bench's step (``bench.py`` ``measure``'s ``scoring_step``) on the
  same weights: JAX at ``backend='xla'``, its fused input block as the
  Pallas kernel in interpreter mode.  Bars: f32 rtol 1e-4 / atol 1e-5;
  bf16 with f32 cell state rtol 0.05 / atol 0.02.
- The measurements return positive rates and chain their state; the
  plain route restores the kernels' entry points; ``main`` refuses to run
  without a card, and the baseline caches its figure with its host.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from vad_tpu.models.video_autoencoder import ConvLSTM as JaxConvLSTM
from vad_tpu.models.video_autoencoder import VideoAutoencoder as JaxVAE
from vad_tpu.ops import encoder_pallas
from vad_tpu.utils.precision import cast_floating as jax_cast_floating
from vad_tpu_torch import bench
from vad_tpu_torch.core.config import VideoAEConfig
from vad_tpu_torch.ops import convlstm, encoder_fused
from vad_tpu_torch.ops.plain import plain_versions
from vad_tpu_torch.utils import baseline_torch
from vad_tpu_torch.utils.weights import load_flax_variables

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.02)
S, T, SIZE, WIDTH = 2, 4, 32, 16  # streams, frames a chunk, frame size, latent = hidden
SMALL = VideoAEConfig(latent_dim=WIDTH, lstm_hidden_dim=WIDTH, lstm_layers=1,
                      image_size=SIZE, sequence_length=T)
DTYPES = {"f32": (torch.float32, jnp.float32, F32), "bf16": (torch.bfloat16, jnp.bfloat16, BF16)}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(encoder_pallas.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def jax_variables(jmodel, seed=0):
    """JAX init with BatchNorm statistics and biases drawn off identity, so
    the folded first block is exercised for real."""
    init = jmodel.init(jax.random.key(seed), jnp.zeros((1, 2, SIZE, SIZE, 3)), train=False)
    rng = np.random.default_rng(seed)

    def walk(tree, name=""):
        if hasattr(tree, "items"):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        if name == "bias":
            return a + rng.normal(size=a.shape).astype(np.float32) * 0.05
        if name == "mean":
            return rng.normal(size=a.shape).astype(np.float32) * 0.05
        if name == "var":
            return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
        return a

    return walk(init)


def jax_scoring_step(jmodel, variables, fused, dtype):
    """The JAX bench's ``scoring_step`` (``bench.py`` ``measure``)."""
    cast_vars = jax_cast_floating(variables, dtype)
    if fused:
        w_band, bias_folded = encoder_pallas.fold_from_variables(variables)
        w_band = jnp.asarray(w_band, jnp.float32).astype(dtype)
        bias_folded = jnp.asarray(bias_folded, jnp.float32)

        def step(u8_chunk, states):
            s, t, h, w, _ = u8_chunk.shape
            _, _, frame_scores, new_states = jmodel.apply(
                cast_vars, u8_chunk.reshape(s, t, h, w * 3), states, w_band, bias_folded,
                False, method=JaxVAE.stream_step_u8)
            return frame_scores.astype(jnp.float32), new_states
    else:
        def step(u8_chunk, states):
            x = u8_chunk.astype(dtype) / jnp.asarray(127.5, dtype) - jnp.asarray(1.0, dtype)
            _, _, frame_scores, new_states = jmodel.apply(
                cast_vars, x, states, method=JaxVAE.stream_step)
            return frame_scores.astype(jnp.float32), new_states
    return jax.jit(step)


def small_pair():
    """The JAX model (``backend='xla'``) and the port's on the same weights."""
    jmodel = JaxVAE(backend="xla", latent_dim=WIDTH, lstm_hidden_dim=WIDTH, lstm_layers=1)
    variables = jax_variables(jmodel)
    model = bench.video_model("cpu", cfg=SMALL)
    load_flax_variables(model, variables)
    return jmodel, variables, model


def small_src(n=12, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)


# ------------------------------------------------------------ FLOPs, frames


@pytest.mark.parametrize("stem", ["pool", "stride2"])
@pytest.mark.parametrize("size", [64, 128, 256])
def test_flop_counts_equal_jax_bench(size, stem):
    assert bench.model_flops_per_frame(size, stem) == jax_bench.model_flops_per_frame(size, stem)
    assert bench.image_model_flops(size) == jax_bench.image_model_flops(size)


def test_flop_counts_at_full_width_and_mfu():
    assert bench.model_flops_per_frame(256) == 3_011_510_272
    assert bench.model_flops_per_frame(256, "stride2") == 1_794_113_536
    assert bench.image_model_flops(256) == 8_111_783_936
    assert bench.H100_PEAK_BF16_FLOPS == 989e12
    # JAX's definition: model FLOP/s over the bf16 peak, training as 3x forward
    flops = bench.model_flops_per_frame(256)
    assert bench.mfu(23_435.0, flops) == pytest.approx(23_435.0 * flops / 989e12)
    assert round(bench.mfu(23_435.0, flops), 3) == 0.071
    assert round(bench.mfu(1_966.0, flops, passes=3), 3) == 0.018


def test_source_frames_equal_jax_bench_byte_for_byte(tmp_path, monkeypatch):
    """``make_source_frames(4, 32)`` against the JAX bench's, whose fixed
    /tmp path is mapped into the test's directory (and must be used: the
    JAX bench falls back to random frames when it cannot decode)."""
    import cv2

    import vad_tpu.data.synthetic as jax_synthetic

    fixed = "/tmp/vad_bench_720p.mp4"
    mapped = str(tmp_path / "jax_720p.mp4")
    written, opened = [], []
    write, capture = jax_synthetic.create_synthetic_video_file, cv2.VideoCapture

    def write_mapped(path, **kw):
        written.append(path)
        return write(mapped if path == fixed else path, **kw)

    def capture_mapped(path):
        opened.append(path)
        return capture(mapped if path == fixed else path)

    monkeypatch.setattr(jax_synthetic, "create_synthetic_video_file", write_mapped)
    monkeypatch.setattr(cv2, "VideoCapture", capture_mapped)
    want = jax_bench.make_source_frames(4, 32)
    assert written == [fixed] and opened == [fixed]
    monkeypatch.setattr(cv2, "VideoCapture", capture)
    got = bench.make_source_frames(4, 32, tmp_path)
    assert got.dtype == np.uint8 and got.shape == (4, 32, 32, 3)
    np.testing.assert_array_equal(got, want)


def test_source_frames_fail_without_opencv(monkeypatch):
    """No silent random-frame fallback: a missing OpenCV names itself."""
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *args, **kw):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(RuntimeError, match="OpenCV"):
        bench.make_source_frames(2, 32)


# ------------------------------------------------------------ scoring steps


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("form", bench.FORMS)
def test_scoring_step_matches_jax_bench(form, dtype):
    tdtype, jdtype, bar = DTYPES[dtype]
    jmodel, variables, model = small_pair()
    jstep = jax_scoring_step(jmodel, variables, form == "fused", jdtype)
    step = bench.scoring_step(model, form, tdtype)
    jstates = JaxConvLSTM.zero_state(1, S, SIZE // 16, SIZE // 16, WIDTH, dtype=jnp.float32)
    states = model.zero_state(S, SIZE, SIZE)
    rng = np.random.default_rng(7)
    for _ in range(2):
        u8 = rng.integers(0, 256, (S, T, SIZE, SIZE, 3), dtype=np.uint8)
        jscores, jstates = jstep(jnp.asarray(u8), jstates)
        scores, states = step(torch.from_numpy(u8), states)
        assert scores.dtype == torch.float32 and scores.shape == (S, T)
        np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), **bar)
    for (h, c), (jh, jc) in zip(states, jstates):
        assert h.dtype == c.dtype == torch.float32
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **bar)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **bar)
    # the step holds its own cast copy: the caller's model stays f32
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_scoring_step_refusals():
    with pytest.raises(ValueError, match="unknown scoring form"):
        bench.scoring_step(bench.video_model("cpu", cfg=SMALL), "xla")
    stride2 = bench.video_model("cpu", cfg=VideoAEConfig(latent_dim=WIDTH, lstm_hidden_dim=WIDTH,
                                                         lstm_layers=1, stem="stride2"))
    step = bench.scoring_step(stride2, "fused")
    with pytest.raises(ValueError, match="stride2 stem has no pool"):
        step(torch.zeros((1, T, SIZE, SIZE, 3), dtype=torch.uint8), stride2.zero_state(1, 32, 32))


def test_plain_versions_restore_the_kernels_after_an_exception():
    kernel_1, kernel_4 = convlstm.convlstm_recurrence, encoder_fused.fused_first_block
    with pytest.raises(RuntimeError, match="inside"):
        with plain_versions():
            assert convlstm.convlstm_recurrence is convlstm.convlstm_recurrence_ref
            assert encoder_fused.fused_first_block is encoder_fused.fused_first_block_ref
            raise RuntimeError("inside")
    assert convlstm.convlstm_recurrence is kernel_1
    assert encoder_fused.fused_first_block is kernel_4


def test_plain_step_routes_only_its_own_calls(monkeypatch):
    """The plain form never reaches the kernels' entry point; the kernel
    form, run after it, reaches it again (once a layer)."""
    calls = []
    entry = convlstm.convlstm_recurrence

    def counted_entry(*args, **kw):
        calls.append("kernel")
        return entry(*args, **kw)

    monkeypatch.setattr(convlstm, "convlstm_recurrence", counted_entry)
    model = bench.video_model("cpu", cfg=SMALL)
    u8 = torch.from_numpy(small_src(T)[None].repeat(S, 0))
    bench.scoring_step(model, "plain")(u8, model.zero_state(S, SIZE, SIZE))
    assert calls == [] and convlstm.convlstm_recurrence is counted_entry
    bench.scoring_step(model, "kernel")(u8, model.zero_state(S, SIZE, SIZE))
    assert calls == ["kernel"]


# ------------------------------------------------------------ measurements


@pytest.mark.parametrize("form", ["fused", "plain"])
def test_measure_chains_the_carried_state(form):
    src = small_src()
    model = bench.video_model("cpu", cfg=SMALL)
    fps, states = bench.measure("cpu", form, T, src=src, streams=S, model=model,
                                n_iters=3, n_windows=2)
    assert fps > 0
    # the warm-up step and 2 windows of 3 steps, each from the last's state
    step = bench.scoring_step(model, form)
    chunks = bench.make_chunks(src, S, T, "cpu")
    want = model.zero_state(S, SIZE, SIZE)
    for i in [0] + [0, 1, 2] * 2:
        _, want = step(chunks[i], want)
    for (h, c), (wh, wc) in zip(states, want):
        torch.testing.assert_close(h, wh, rtol=0, atol=0)
        torch.testing.assert_close(c, wc, rtol=0, atol=0)
    assert bool(states[0][0].ne(0).any())


def test_measure_image_scores_the_resident_batches():
    from vad_tpu_torch.models.autoencoder import ConvAutoencoder

    model = ConvAutoencoder(latent_dim=32, device="cpu").eval()
    src = small_src(20)
    rate, scores = bench.measure_image("cpu", src, batch=6, model=model, n_iters=3, n_windows=2)
    assert rate > 0 and scores.shape == (6,) and scores.dtype == torch.float32
    x = torch.from_numpy(src[(np.arange(6) + 37 * 2) % 20]).to(torch.bfloat16) / 127.5 - 1.0
    with torch.no_grad():
        want = model.to(torch.bfloat16).reconstruction_error(x).float()
    torch.testing.assert_close(scores, want, rtol=0, atol=0)


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_measure_train_chains_its_steps(compute_dtype):
    model = bench.video_model("cpu", cfg=SMALL)
    before = [p.detach().clone() for p in model.parameters()]
    rate, optimizer = bench.measure_train("cpu", small_src(), compute_dtype, batch=2,
                                          chunk_t=T, model=model, n_iters=2, n_windows=2)
    assert rate > 0
    steps = {int(s["step"]) for s in optimizer.state.values()}
    assert steps == {1 + 2 * 2}  # warm-up + 2 windows of 2
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert any(not torch.equal(p, b) for p, b in zip(model.parameters(), before))


def test_end_to_end_lines_count_every_frame(tmp_path):
    """The decode-included lines at a tiny size: every decoded frame is
    scored (a short last chunk counts its real frames only)."""
    model = bench.video_model("cpu", cfg=SMALL)
    e2e, decode = bench.measure_e2e_mp4("cpu", tmp_path, n_frames=6, chunk_t=T,
                                        image_size=SIZE, model=model)
    assert e2e > 0 and decode > 0
    agg, agg_decode = bench.measure_e2e_multistream("cpu", tmp_path, n_streams=2, n_frames=5,
                                                    chunk_t=T, image_size=SIZE, model=model)
    assert agg > 0 and agg_decode > 0


# ------------------------------------------------------------ main, baseline


def test_main_refuses_without_a_card_and_prints_nothing(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])
    assert capsys.readouterr().out == ""


def test_baseline_caches_its_figure_with_its_host(tmp_path):
    cache = tmp_path / "build" / "baseline.json"
    fps = baseline_torch.measure_reference_cpu_fps(32, 4, n_windows=2, cache=cache)
    assert fps > 0
    data = json.loads(cache.read_text())
    assert data["torch_cpu_fps_32_4"] == fps  # the JAX package's key
    host = baseline_torch.cached_host(32, 4, cache)
    assert host == {"cpu": baseline_torch.host_cpu(), "threads": torch.get_num_threads()}
    assert baseline_torch.measure_reference_cpu_fps(32, 4, cache=cache) == fps  # cached
    assert baseline_torch.CACHE.parent.name == "build"
    assert baseline_torch.CACHE.parent.parent.name == "vad_tpu_torch"
