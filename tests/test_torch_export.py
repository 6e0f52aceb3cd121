"""The port's ``torch.export`` serving artifacts (``vad_tpu_torch/utils/export.py``)
against the live port model and against the JAX package's StableHLO
artifacts on the same weights, on the CPU.

Inputs from a numpy seed; weights from the port's ``init_weights``
(BatchNorm statistics off identity), handed to JAX as its variables tree.
Bars: the JAX package's export tests' (image rtol 1e-6 / atol 1e-7, video
rtol 1e-5 / atol 1e-7) against the live model; the f32 parity bar (rtol
1e-4 / atol 1e-5) against JAX's artifact, a separate lowering.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vad_tpu.models.autoencoder import ConvAutoencoder as JaxAE
from vad_tpu.models.video_autoencoder import ConvLSTM as JaxConvLSTM
from vad_tpu.models.video_autoencoder import VideoAutoencoder as JaxVAE
from vad_tpu.utils import export as jax_export
from vad_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from vad_tpu_torch import export_model as cli
from vad_tpu_torch.eval.serving import MultiStreamScorer
from vad_tpu_torch.models.autoencoder import ConvAutoencoder
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
from vad_tpu_torch.ops import convlstm
from vad_tpu_torch.utils import export
from vad_tpu_torch.utils.weights import state_dict_to_flax

SIZE, LATENT, HIDDEN, SLOTS, CHUNK = 64, 16, 16, 2, 4
IMAGE_BAR = dict(rtol=1e-6, atol=1e-7)
VIDEO_BAR = dict(rtol=1e-5, atol=1e-7)
F32 = dict(rtol=1e-4, atol=1e-5)


def _np(t):
    return t.detach().float().cpu().numpy()


@pytest.fixture(scope="module")
def video_model():
    return init_weights(VideoAutoencoder(latent_dim=LATENT, lstm_hidden_dim=HIDDEN,
                                         device="cpu"), 0).eval()


@pytest.fixture(scope="module")
def image_model():
    return init_weights(ConvAutoencoder(latent_dim=LATENT, device="cpu"), 1).eval()


@pytest.fixture(scope="module")
def image_artifact(image_model, tmp_path_factory):
    exported = export.export_image_scorer(image_model, SIZE, dtype=torch.float32)
    path = export.save_artifact(exported, tmp_path_factory.mktemp("img") / "img.pt2",
                                meta={"kind": "image"})
    return export.load_artifact(path, "cpu"), path


@pytest.fixture(scope="module")
def video_artifact(video_model, tmp_path_factory):
    exported = export.export_video_stream_step(video_model, num_slots=SLOTS, chunk=CHUNK,
                                               image_size=SIZE, dtype=torch.float32)
    path = export.save_artifact(exported, tmp_path_factory.mktemp("vid") / "vid.pt2")
    return export.load_artifact(path, "cpu"), path


def _frames(seed, b=SLOTS):
    return np.random.default_rng(seed).integers(0, 256, (b, CHUNK, SIZE, SIZE, 3), np.uint8)


def _zero_states(model):
    return model.zero_state(SLOTS, SIZE, SIZE)


def _scorer(model, **kw):
    """A CPU scorer over every slot, on a copy (a scorer casts its model)."""
    scorer = MultiStreamScorer(copy.deepcopy(model), None, SLOTS, CHUNK, SIZE, device="cpu", **kw)
    for slot in range(SLOTS):
        scorer.attach(slot)
    return scorer


@pytest.mark.parametrize("batch", (1, 3, 7))
def test_image_symbolic_batch_roundtrip(image_model, image_artifact, batch):
    """One artifact, any batch (1 included): saved, loaded and called, it
    scores as the live model does."""
    loaded, _ = image_artifact
    u8 = np.random.default_rng(batch).integers(0, 256, (batch, SIZE, SIZE, 3), np.uint8)
    got = loaded.call(u8)
    with torch.no_grad():
        want = image_model.reconstruction_error(torch.from_numpy(u8).float() / 127.5 - 1.0)
    assert got.shape == (batch,) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **IMAGE_BAR)


def test_image_pinned_batch_rejects_other_sizes(image_model):
    exported = export.export_image_scorer(image_model, SIZE, batch=4, dtype=torch.float32)
    assert tuple(exported.call(np.zeros((4, SIZE, SIZE, 3), np.uint8)).shape) == (4,)
    with pytest.raises(Exception):
        exported.call(np.zeros((2, SIZE, SIZE, 3), np.uint8))
    assert not exported.uses_shape_polymorphism


def test_video_stream_step_threads_state_like_scorer(video_model, video_artifact):
    """Two calls with the state threaded by hand reproduce the live
    MultiStreamScorer's scores."""
    loaded, _ = video_artifact
    scorer = _scorer(video_model)
    states, submitted = _zero_states(video_model), np.ones(SLOTS, bool)
    for i in range(2):
        frames = _frames(10 + i)
        want = scorer.score_chunk(frames)
        scores, states = loaded.call(frames, states, submitted)
        np.testing.assert_allclose(_np(scores), want, **VIDEO_BAR)
    for (h, c), (sh, sc) in zip(states, scorer.states):
        np.testing.assert_allclose(_np(h), _np(sh), **VIDEO_BAR)
        np.testing.assert_allclose(_np(c), _np(sc), **VIDEO_BAR)


def test_video_submitted_mask_preserves_state(video_model, video_artifact):
    loaded, _ = video_artifact
    frames = _frames(3)
    _, states = loaded.call(frames, _zero_states(video_model), np.ones(SLOTS, bool))
    _, after = loaded.call(frames, states, np.array([True, False]))
    for (h0, c0), (h1, c1) in zip(states, after):
        assert torch.equal(h0[1], h1[1]) and torch.equal(c0[1], c1[1])
        assert not torch.equal(h0[0], h1[0])


def test_recurrence_is_one_operator_node_a_layer(video_artifact):
    """The graph holds kernel 1's operator once a layer and no unrolled
    time loop (the plain recurrence's sigmoids)."""
    loaded, _ = video_artifact
    targets = [str(n.target) for n in loaded.program.graph.nodes if n.op == "call_function"]
    assert sum("vad_tpu_torch.convlstm_recurrence" in t for t in targets) == 2
    assert not any("sigmoid" in t for t in targets)


def test_bf16_artifact_equals_unfused_bf16_scorer(video_model, tmp_path):
    """bf16: every floating weight and BatchNorm statistic cast, the input
    normalized in bf16 — the scorer's unfused bf16 step, bit for bit."""
    exported = export.export_video_stream_step(video_model, num_slots=SLOTS, chunk=CHUNK,
                                               image_size=SIZE)
    loaded = export.load_artifact(export.save_artifact(exported, tmp_path / "b.pt2"), "cpu")
    scorer = _scorer(video_model, dtype=torch.bfloat16, fused_input=False)
    states = _zero_states(video_model)
    for i in range(2):
        frames = _frames(20 + i)
        scores, states = loaded.call(frames, states, np.ones(SLOTS, bool))
        np.testing.assert_array_equal(_np(scores), scorer.score_chunk(frames))


def test_image_artifact_matches_jax_artifact(image_model, image_artifact, tmp_path):
    loaded, _ = image_artifact
    variables = state_dict_to_flax(image_model)
    jexp = jax_export.export_image_scorer(JaxAE(latent_dim=LATENT), variables, SIZE,
                                          dtype=jnp.float32)
    jloaded = jax_export.load_artifact(jax_export.save_artifact(jexp, tmp_path / "j.stablehlo"))
    u8 = np.random.default_rng(5).integers(0, 256, (3, SIZE, SIZE, 3), np.uint8)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jloaded.call(u8))
    np.testing.assert_allclose(_np(loaded.call(u8)), want, **F32)


def test_video_artifact_matches_jax_artifact(video_model, video_artifact):
    loaded, _ = video_artifact
    variables = state_dict_to_flax(video_model)
    jmodel = JaxVAE(latent_dim=LATENT, lstm_hidden_dim=HIDDEN, backend="xla")
    with jax.default_matmul_precision("highest"):
        jexp = jax_export.export_video_stream_step(jmodel, variables, num_slots=SLOTS,
                                                   chunk=CHUNK, image_size=SIZE,
                                                   dtype=jnp.float32)
    jstates = JaxConvLSTM.zero_state(2, SLOTS, SIZE // 16, SIZE // 16, HIDDEN,
                                     dtype=jnp.float32)
    states, submitted = _zero_states(video_model), np.array([True, False])
    for i in range(2):
        frames = _frames(30 + i)
        scores, states = loaded.call(frames, states, submitted)
        jscores, jstates = jexp.call(frames, jstates, submitted)
        np.testing.assert_allclose(_np(scores), np.asarray(jscores), **F32)
        for (h, c), (jh, jc) in zip(states, jstates):
            np.testing.assert_allclose(_np(h), np.asarray(jh), **F32)
            np.testing.assert_allclose(_np(c), np.asarray(jc), **F32)
        submitted = np.ones(SLOTS, bool)


@pytest.mark.parametrize("batch", (None, 4), ids=("symbolic", "pinned"))
def test_sidecar_matches_jax(image_model, tmp_path, batch):
    """The sidecar has the JAX package's keys, and the same shape
    polymorphism flag, read from the inputs."""
    exported = export.export_image_scorer(image_model, SIZE, batch=batch, dtype=torch.float32)
    path = export.save_artifact(exported, tmp_path / "a.pt2", meta={"kind": "image"})
    ours = json.loads((tmp_path / "a.pt2.json").read_text())
    jexp = jax_export.export_image_scorer(JaxAE(latent_dim=LATENT),
                                          state_dict_to_flax(image_model), SIZE, batch=batch,
                                          dtype=jnp.float32)
    jax_export.save_artifact(jexp, tmp_path / "a.stablehlo", meta={"kind": "image"})
    theirs = json.loads((tmp_path / "a.stablehlo.json").read_text())
    assert ours.keys() == theirs.keys()
    assert ours["uses_shape_polymorphism"] is theirs["uses_shape_polymorphism"]
    assert ours["bytes"] == path.stat().st_size and ours["platforms"] == ["cpu"]
    assert ours["in_avals"][0].startswith("uint8[") and ours["out_avals"][0].startswith("float32")
    assert not path.with_name("a.pt2.tmp").exists()


def test_cli_on_jax_written_checkpoint(video_model, tmp_path, capsys):
    """``python -m vad_tpu_torch.export_model`` on a ``.ckpt`` the JAX
    package wrote: JAX's printed lines and sidecar keys, the threshold in
    the meta, and the artifact scores as the live model does."""
    ckpt = tmp_path / "best_model.ckpt"
    jax_save_checkpoint(ckpt, {**state_dict_to_flax(video_model), "model_type": "video",
                               "args": {"image_size": SIZE, "latent_dim": LATENT,
                                        "lstm_hidden_dim": HIDDEN},
                               "frame_score_threshold": 0.01})
    out = tmp_path / "vid.pt2"
    cli.main(["--checkpoint", str(ckpt), "--output", str(out), "--slots", str(SLOTS),
              "--chunk", str(CHUNK), "--dtype", "float32", "--device", "cpu",
              "--platforms", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == f"Exported {ckpt}" and printed[2].startswith("  in:  [")
    sidecar = json.loads((tmp_path / "vid.pt2.json").read_text())
    assert (sidecar["kind"], sidecar["num_slots"], sidecar["chunk"]) == ("video", SLOTS, CHUNK)
    assert sidecar["score_threshold"] == 0.01 and sidecar["platforms"] == ["cpu"]
    loaded = export.load_artifact(out, "cpu")
    frames = _frames(40)
    scores, _ = loaded.call(frames, _zero_states(video_model), np.ones(SLOTS, bool))
    scorer = _scorer(video_model)
    np.testing.assert_allclose(_np(scores), scorer.score_chunk(frames), **VIDEO_BAR)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
def test_operator_fake_shapes_match_plain(dtype):
    """The operator's fake implementation (what ``torch.export`` traces
    with) gives the plain version's shapes and types."""
    rng = np.random.default_rng(0)
    gx = torch.from_numpy(rng.normal(size=(2, 3, 4, 5, 4 * 8)).astype(np.float32)).to(dtype)
    wh = torch.from_numpy(rng.normal(size=(3, 3, 8, 32)).astype(np.float32)).to(dtype) * 0.1
    h0 = torch.zeros((2, 4, 5, 8))
    want = convlstm.convlstm_recurrence_ref(gx, wh, h0, h0)
    metas = [t.to("meta") for t in (gx, wh, h0, h0)]
    fake = torch.ops.vad_tpu_torch.convlstm_recurrence(*metas)
    for got, ref in zip(fake, (want[0], *want[1])):
        assert (got.shape, got.dtype) == (ref.shape, ref.dtype)


def test_platforms():
    assert export._platform_list(["GPU", "cuda", "cpu"]) == ["cuda", "cpu"]
    assert export._platform_list(None) is None
    with pytest.raises(ValueError, match="JAX package"):
        export._platform_list(["tpu"])
    with pytest.raises(ValueError, match="unknown platform"):
        export._platform_list(["rocm"])


def test_defaults_to_the_card(image_artifact):
    """``device=None`` means CUDA: without a card, loading and exporting
    from a checkpoint raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    _, path = image_artifact
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.load_artifact(path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--checkpoint", "x.ckpt", "--output", "y.pt2"])
