"""The folded quadtree decoder (``vad_tpu_torch/ops/decoder_fast.py``) and
``VideoAutoencoder.stream_step_fast`` against the JAX package's on the same
weights, on the CPU, f32 at rtol 1e-5.

Variables are the JAX model's init with biases, norm scales and BatchNorm
statistics redrawn off identity from a numpy seed (so the fold is
exercised), at latent 16 / hidden 16 and 64x64 frames (4x4 latents).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vad_tpu.models.video_autoencoder import ConvLSTM as JaxConvLSTM
from vad_tpu.models.video_autoencoder import VideoAutoencoder as JaxVAE
from vad_tpu.ops import decoder_fast as jax_fast
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
from vad_tpu_torch.ops import decoder_fast
from vad_tpu_torch.utils.weights import load_flax_variables

LATENT, SIZE = 16, 64
BAR = dict(rtol=1e-5, atol=1e-6)


def _variables(seed=0, norm="batch"):
    """JAX's init (Xavier kernels) with biases, norm scales and BatchNorm
    statistics redrawn off identity from a numpy seed."""
    rng = np.random.default_rng(seed)
    model = JaxVAE(latent_dim=LATENT, lstm_hidden_dim=LATENT, norm=norm, backend="xla")
    init = model.init(jax.random.key(seed), jnp.zeros((1, 2, SIZE, SIZE, 3)), train=False)

    def walk(tree, name=""):
        if hasattr(tree, "items"):
            return {k: walk(v, k) for k, v in tree.items()}
        a = np.asarray(tree, np.float32)
        if name in ("bias", "mean", "scale"):
            return a + rng.normal(size=a.shape).astype(np.float32) * 0.1
        if name == "var":
            return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
        return a

    return model, walk(init)


def _port(variables, norm="batch"):
    model = VideoAutoencoder(latent_dim=LATENT, lstm_hidden_dim=LATENT, norm=norm, device="cpu")
    return load_flax_variables(model, variables).eval()


def test_fold_matches_jax():
    _, variables = _variables()
    ours = decoder_fast.fold_decoder_params(variables, dtype=torch.float32)
    theirs = jax_fast.fold_decoder_params(variables, dtype=jnp.float32)
    for (w, b), (jw, jb) in zip(ours, theirs):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_decode_quadtree_matches_jax_and_the_decoder():
    """Quadtree rows equal JAX's, and in raster order they are the port's
    ConvTranspose decoder's output (the flipped-kernel fold is right)."""
    model, variables = _variables(1)
    z = np.random.default_rng(2).standard_normal((3, 4, 4, LATENT)).astype(np.float32)
    got = decoder_fast.decode_quadtree(
        torch.from_numpy(z), decoder_fast.fold_decoder_params(variables, torch.float32))
    want = jax_fast.decode_quadtree(jnp.asarray(z),
                                    jax_fast.fold_decoder_params(variables, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAR)
    with torch.no_grad():
        raster = _port(variables).decoder(torch.from_numpy(z))
    np.testing.assert_allclose(
        decoder_fast.raster_from_quadtree(got, (3,), SIZE, SIZE).numpy(), raster.numpy(), **BAR)
    np.testing.assert_allclose(got.numpy(), decoder_fast.quadtree_view(raster).numpy(), **BAR)


def test_quadtree_views_match_jax():
    x = np.random.default_rng(3).standard_normal((2, 5, 32, 32, 3)).astype(np.float32)
    q = decoder_fast.quadtree_view(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jax_fast.quadtree_view(jnp.asarray(x))))
    assert q.shape == (2 * 5 * 32 * 32, 3)
    back = decoder_fast.raster_from_quadtree(q, (2, 5), 32, 32)
    np.testing.assert_array_equal(back.numpy(), x)


def test_group_norm_rejected():
    _, variables = _variables(norm="group")
    with pytest.raises(ValueError, match="group"):
        decoder_fast.fold_decoder_params(variables)


def test_stream_step_fast_matches_jax():
    """Two chunks with the state carried: quadtree reconstructions, error
    maps, frame scores and every layer's (h, c) against JAX's."""
    model, variables = _variables(4)
    port = _port(variables)
    folded = decoder_fast.fold_decoder_params(variables, torch.float32)
    jfolded = jax_fast.fold_decoder_params(variables, jnp.float32)
    rng = np.random.default_rng(5)
    states = port.zero_state(2, SIZE, SIZE)
    jstates = JaxConvLSTM.zero_state(2, 2, SIZE // 16, SIZE // 16, LATENT, dtype=jnp.float32)
    for _ in range(2):
        x = rng.uniform(-1, 1, (2, 3, SIZE, SIZE, 3)).astype(np.float32)
        with torch.no_grad():
            recon, err, scores, states = port.stream_step_fast(torch.from_numpy(x), states, folded)
        with jax.default_matmul_precision("highest"):
            jrecon, jerr, jscores, jstates = model.apply(
                variables, jnp.asarray(x), jstates, jfolded,
                method=JaxVAE.stream_step_fast)
        for got, want in ((recon, jrecon), (err, jerr), (scores, jscores)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAR)
        for (h, c), (jh, jc) in zip(states, jstates):
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), **BAR)
            np.testing.assert_allclose(c.numpy(), np.asarray(jc), **BAR)


def test_stream_step_fast_matches_stream_step():
    """The same scores and state as the port's ConvTranspose step; without
    the error map it returns None."""
    _, variables = _variables(6)
    port = _port(variables)
    folded = decoder_fast.fold_decoder_params(variables, torch.float32)
    x = torch.from_numpy(np.random.default_rng(7).uniform(-1, 1, (2, 3, SIZE, SIZE, 3))
                         .astype(np.float32))
    with torch.no_grad():
        _, err, scores, states = port.stream_step(x, port.zero_state(2, SIZE, SIZE))
        _, ferr, fscores, fstates = port.stream_step_fast(x, port.zero_state(2, SIZE, SIZE),
                                                          folded)
        _, none, _, _ = port.stream_step_fast(x, port.zero_state(2, SIZE, SIZE), folded, False)
    assert none is None
    np.testing.assert_allclose(fscores.numpy(), scores.numpy(), **BAR)
    np.testing.assert_allclose(ferr.numpy(), err.numpy(), **BAR)
    for (h, c), (fh, fc) in zip(states, fstates):
        assert torch.equal(h, fh) and torch.equal(c, fc)


def test_bf16_fold_no_worse_than_bf16_decoder():
    """In bf16 the folded decoder is no further from the f32 decoder than
    the bf16 ConvTranspose decoder it replaces."""
    _, variables = _variables(8)
    z = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 4, 4, LATENT))
                         .astype(np.float32))
    port = _port(variables)
    with torch.no_grad():
        ref32 = port.decoder(z)
        refb = port.to(torch.bfloat16).decoder(z.bfloat16()).float()
    got = decoder_fast.raster_from_quadtree(
        decoder_fast.decode_quadtree(z.bfloat16(), decoder_fast.fold_decoder_params(variables)),
        (2,), SIZE, SIZE).float()
    assert float((got - ref32).abs().max()) <= float((refb - ref32).abs().max()) * 1.2 + 1e-4
