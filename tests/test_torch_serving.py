"""The PyTorch port's MultiStreamScorer against the JAX package's, on the CPU.

Same variables and the same uint8 frames through both scorers over several
chunks while slots attach, detach, sit idle (unsubmitted) and reload
weights.  JAX runs its plain ``backend='xla'`` scorer, and the fused u8
input block as its Pallas kernel in interpreter mode.

Bars: f32 rtol 1e-4 / atol 1e-5; bf16 with f32 cell state rtol 0.05 /
atol 0.02.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vad_tpu.eval.serving import MultiStreamScorer as JaxScorer
from vad_tpu.models.video_autoencoder import VideoAutoencoder as JaxVAE
from vad_tpu.ops import encoder_pallas
from vad_tpu_torch.eval.serving import MultiStreamScorer
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.02)
SIZE, SLOTS, CHUNK = 64, 3, 3


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    import jax.experimental.pallas as pl

    monkeypatch.setattr(encoder_pallas.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def variables_for(jmodel, seed, hw=(SIZE, SIZE)):
    """JAX init with norm statistics and biases drawn off identity."""
    init = jmodel.init(jax.random.key(seed), jnp.zeros((1, 2, *hw, 3)), train=False)
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


def models(norm="batch", stem="pool", hidden=32, layers=2):
    kw = dict(latent_dim=32, lstm_hidden_dim=hidden, lstm_layers=layers, norm=norm, stem=stem)
    return JaxVAE(backend="xla", **kw), VideoAutoencoder(device="cpu", **kw)


def chunk_frames(seed, hw=(SIZE, SIZE)):
    rng = np.random.default_rng(100 + seed)
    return rng.integers(0, 256, (SLOTS, CHUNK, *hw, 3), dtype=np.uint8)


def pair(fused=False, dtype=torch.float32, return_maps=True, seed=0, **model_kw):
    jmodel, tmodel = models(**model_kw)
    variables = variables_for(jmodel, seed)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    js = JaxScorer(jmodel, variables, SLOTS, CHUNK, SIZE, return_maps=return_maps, dtype=jdtype,
                   fused_input=fused)
    ts = MultiStreamScorer(tmodel, variables, SLOTS, CHUNK, SIZE, return_maps=return_maps,
                           dtype=dtype, fused_input=fused, device="cpu")
    return js, ts


def assert_same_scores(got, want, bar):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(np.asarray(want)), **bar)


def assert_same_states(ts, js, bar):
    for (h, c), (jh, jc) in zip(ts.states, js.states):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **bar)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), **bar)


@pytest.mark.parametrize("fused", [False, True], ids=["plain_input", "fused_input"])
def test_scorer_matches_jax_through_slot_lifecycle(fused):
    """attach / idle (unsubmitted) slot / detach (NaN) / re-attach (reset),
    scores, error maps and carried states equal JAX's at every chunk."""
    js, ts = pair(fused=fused)
    assert ts.fused_input is fused
    steps = [
        (("attach", 0), ("attach", 1)),  # slot 2 inactive: NaN
        (("attach", 2),),
        ((None, None),),  # submitted mask below: slot 1 idle
        (("detach", 1),),
        (("attach", 1),),  # re-attached: state zeroed
    ]
    for i, ops in enumerate(steps):
        for op, slot in ops:
            if op == "attach":
                assert ts.attach(slot) == js.attach(slot)
            elif op == "detach":
                ts.detach(slot)
                js.detach(slot)
        submitted = np.array([True, False, True]) if i == 2 else None
        frames = chunk_frames(i)
        (t_scores, t_maps), (j_scores, j_maps) = (
            s.score_chunk(frames, submitted) for s in (ts, js))
        assert t_scores.dtype == np.float32 and t_scores.shape == (SLOTS, CHUNK)
        assert_same_scores(t_scores, j_scores, F32)
        np.testing.assert_allclose(t_maps, np.asarray(j_maps), **F32)
        assert_same_states(ts, js, F32)
    np.testing.assert_array_equal(ts.active_slots, js.active_slots)


def test_idle_slot_state_is_bit_identical():
    _, ts = pair()
    for slot in range(SLOTS):
        ts.attach(slot)
    ts.score_chunk(chunk_frames(0))
    before = [(h[1].clone(), c[1].clone()) for h, c in ts.states]
    ts.score_chunk(chunk_frames(1), np.array([True, False, True]))
    for (h, c), (h0, c0) in zip(ts.states, before):
        assert torch.equal(h[1], h0) and torch.equal(c[1], c0)
        assert bool(h[1].ne(0).any())  # it had advanced before going idle
    ts.detach(1)
    ts.attach(1)
    assert all(not bool(h[1].any()) and not bool(c[1].any()) for h, c in ts.states)


def test_bf16_scorer_matches_jax():
    js, ts = pair(dtype=torch.bfloat16, return_maps=False)
    for slot in range(SLOTS):
        ts.attach(slot)
        js.attach(slot)
    for i in range(2):
        frames = chunk_frames(i)
        assert_same_scores(ts.score_chunk(frames), js.score_chunk(frames), BF16)
    assert all(h.dtype == c.dtype == torch.float32 for h, c in ts.states)
    assert_same_states(ts, js, BF16)


def test_reload_matches_jax_reload():
    js, ts = pair(return_maps=False)
    for slot in range(2):
        ts.attach(slot)
        js.attach(slot)
    ts.score_chunk(chunk_frames(0))
    js.score_chunk(chunk_frames(0))
    new = variables_for(models()[0], seed=7)
    ts.reload_variables(new)
    js.reload_variables(new)
    assert_same_scores(ts.score_chunk(chunk_frames(1)), js.score_chunk(chunk_frames(1)), F32)
    assert_same_states(ts, js, F32)


def test_reload_refolds_fused_input():
    """The eager port re-folds the fused block on reload (JAX refuses the
    reload there, its folded weights being jit constants): a reloaded
    scorer equals a fresh one built on the new weights with the same
    carried state."""
    _, reloaded = pair(fused=True, return_maps=False)
    _, fresh = pair(fused=True, return_maps=False, seed=7)
    for sc in (reloaded, fresh):
        for slot in range(SLOTS):
            sc.attach(slot)
    reloaded.score_chunk(chunk_frames(0))
    reloaded.reload_variables(variables_for(models()[0], seed=7))
    fresh.states = tuple((h.clone(), c.clone()) for h, c in reloaded.states)
    np.testing.assert_array_equal(reloaded.score_chunk(chunk_frames(1)),
                                  fresh.score_chunk(chunk_frames(1)))


def test_reload_rejects_other_architecture():
    _, ts = pair(return_maps=False)
    with pytest.raises((KeyError, ValueError)):
        ts.reload_variables(variables_for(models(hidden=48)[0], seed=1))
    with pytest.raises((KeyError, ValueError)):
        ts.reload_variables(variables_for(models(layers=1)[0], seed=1))


@pytest.mark.parametrize("norm,stem", [("group", "pool"), ("batch", "stride2")])
def test_fused_input_needs_batch_norm_and_pool(norm, stem):
    _, tmodel = models(norm=norm, stem=stem, layers=1)
    with pytest.raises(ValueError, match="fused_input"):
        MultiStreamScorer(tmodel, None, SLOTS, CHUNK, SIZE, fused_input=True, device="cpu")
    assert not MultiStreamScorer(tmodel, None, SLOTS, CHUNK, SIZE, device="cpu").fused_input


def test_fused_input_default_is_off_on_cpu():
    _, tmodel = models(layers=1)
    assert not MultiStreamScorer(tmodel, None, SLOTS, CHUNK, SIZE, device="cpu").fused_input


def test_shape_and_size_validation():
    _, tmodel = models(layers=1)
    with pytest.raises(ValueError, match="divisible by 16"):
        MultiStreamScorer(tmodel, None, SLOTS, CHUNK, 60, device="cpu")
    ts = MultiStreamScorer(tmodel, None, SLOTS, CHUNK, SIZE, device="cpu")
    with pytest.raises(ValueError, match="expected"):
        ts.score_chunk(np.zeros((SLOTS, CHUNK + 1, SIZE, SIZE, 3), np.uint8))
    with pytest.raises(TypeError, match="uint8"):
        ts.score_chunk(np.zeros((SLOTS, CHUNK, SIZE, SIZE, 3), np.float32))


def test_slot_lifecycle_errors():
    _, tmodel = models(layers=1)
    ts = MultiStreamScorer(tmodel, None, SLOTS, CHUNK, SIZE, device="cpu")
    assert [ts.attach() for _ in range(SLOTS)] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="busy"):
        ts.attach()
    with pytest.raises(RuntimeError, match="already attached"):
        ts.attach(1)
    ts.detach(1)
    with pytest.raises(RuntimeError, match="not attached"):
        ts.score_streams({1: list(chunk_frames(0)[1])})


def test_rect_image_size_matches_jax():
    hw = (64, 96)
    jmodel, tmodel = models(layers=1)
    variables = variables_for(jmodel, 3, hw)
    js = JaxScorer(jmodel, variables, SLOTS, CHUNK, hw)
    ts = MultiStreamScorer(tmodel, variables, SLOTS, CHUNK, hw, device="cpu")
    for sc in (js, ts):
        sc.attach(0)
    frames = chunk_frames(0, hw)
    assert_same_scores(ts.score_chunk(frames), js.score_chunk(frames), F32)


def test_score_streams_matches_jax():
    js, ts = pair(return_maps=False)
    for slot in range(SLOTS):
        ts.attach(slot)
        js.attach(slot)
    frames = chunk_frames(0)
    feed = {0: list(frames[0]), 2: list(frames[2])}
    got, want = ts.score_streams(feed), js.score_streams(feed)
    assert sorted(got) == [0, 2]
    for slot in got:
        np.testing.assert_allclose(got[slot], np.asarray(want[slot]), **F32)
    assert_same_states(ts, js, F32)


def test_device_tensor_frames_are_accepted():
    """Frames already on the scorer's device go in without a host copy."""
    _, ts = pair(return_maps=False)
    ts.attach(0)
    frames = chunk_frames(0)
    a = ts.score_chunk(torch.from_numpy(frames))
    ts.detach(0)
    ts.attach(0)
    np.testing.assert_array_equal(a, ts.score_chunk(frames))
