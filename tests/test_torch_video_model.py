"""The PyTorch port's video model against the JAX package's, on the CPU.

Same variables (the JAX model's init, with BatchNorm statistics and every
bias drawn away from their identity values by a numpy seed) loaded into
both; same numpy inputs.  JAX runs its plain ``backend='xla'`` path, and
the Pallas u8 input kernel in interpreter mode.

Bars: f32 rtol 1e-4 / atol 1e-5; bf16 with f32 cell state rtol 0.05 /
atol 0.02.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vad_tpu.models.video_autoencoder import ConvLSTM as JaxConvLSTM
from vad_tpu.models.video_autoencoder import VideoAutoencoder as JaxVAE
from vad_tpu.ops import encoder_pallas
from vad_tpu.utils.precision import cast_floating
from vad_tpu_torch.core.config import VideoAEConfig
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
from vad_tpu_torch.ops.block_epilogue import fold_blocks
from vad_tpu_torch.ops.encoder_fused import fold_from_variables
from vad_tpu_torch.utils.weights import flax_to_state_dict, load_flax_variables

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=0.05, atol=0.02)
SIZE, B, T = 64, 2, 3


@pytest.fixture(autouse=True)
def inference():
    with torch.no_grad():
        yield


def perturbed(tree, rng, path=()):
    """numpy copy of a Flax variables tree with norm statistics, scales and
    biases moved off their init values (zeros / ones)."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: perturbed(v, rng, path + (k,)) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    name = path[-1]
    if name == "bias":
        return a + rng.normal(size=a.shape).astype(np.float32) * 0.05
    if name == "scale":
        return a * (1 + rng.normal(size=a.shape).astype(np.float32) * 0.1)
    if name == "mean":
        return rng.normal(size=a.shape).astype(np.float32) * 0.05
    if name == "var":
        return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
    return a


def build_pair(latent=32, hidden=32, layers=2, norm="batch", stem="pool", seed=0):
    jmodel = JaxVAE(latent_dim=latent, lstm_hidden_dim=hidden, lstm_layers=layers,
                    norm=norm, stem=stem, backend="xla")
    init = jmodel.init(jax.random.key(seed), jnp.zeros((1, 2, SIZE, SIZE, 3)), train=False)
    variables = perturbed(init, np.random.default_rng(seed))
    tmodel = VideoAutoencoder(latent_dim=latent, lstm_hidden_dim=hidden, lstm_layers=layers,
                              norm=norm, stem=stem, device="cpu").eval()
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel


def jax_states(jmodel, b=B):
    return JaxConvLSTM.zero_state(jmodel.lstm_layers, b, SIZE // 16, SIZE // 16,
                                  jmodel.lstm_hidden_dim)


def frames(seed, b=B, t=T):
    return np.random.default_rng(seed).uniform(-1, 1, (b, t, SIZE, SIZE, 3)).astype(np.float32)


def assert_states(got, want, bar):
    assert len(got) == len(want)
    for (h, c), (jh, jc) in zip(got, want):
        assert h.dtype == c.dtype == torch.float32
        np.testing.assert_allclose(h.float().numpy(), np.asarray(jh, np.float32), **bar)
        np.testing.assert_allclose(c.float().numpy(), np.asarray(jc, np.float32), **bar)


@pytest.mark.parametrize("norm,stem,hidden,layers", [
    ("batch", "pool", 32, 2),
    ("batch", "pool", 48, 1),  # hidden != latent: the 1x1 proj is on
    ("group", "pool", 32, 1),
    ("batch", "stride2", 32, 1),
    ("group", "stride2", 48, 2),
])
def test_stream_step_matches_jax(norm, stem, hidden, layers):
    """Two chunks, state carried across: recon, error map, frame scores and
    every layer's (h, c) match."""
    jmodel, variables, tmodel = build_pair(hidden=hidden, layers=layers, norm=norm, stem=stem)
    assert (tmodel.proj is not None) == (hidden != 32)
    jstates, tstates = jax_states(jmodel), tmodel.zero_state(B, SIZE, SIZE)
    for chunk in range(2):
        x = frames(chunk)
        with jax.default_matmul_precision("highest"):
            jr, je, js, jstates = jmodel.apply(variables, jnp.asarray(x), jstates,
                                               method=JaxVAE.stream_step)
        tr, te, ts, tstates = tmodel.stream_step(torch.from_numpy(x), tstates)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **F32)
        np.testing.assert_allclose(te.numpy(), np.asarray(je), **F32)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **F32)
        assert_states(tstates, jstates, F32)


@pytest.mark.parametrize("hidden,layers", [(32, 1), (48, 2)])
def test_stream_step_u8_matches_jax(monkeypatch, hidden, layers):
    """Raw-byte path: the fused u8 input block (Pallas kernel in interpreter
    mode on the JAX side) + blocks 2-4 + ConvLSTM + decoder + flat error;
    the port's blocks 2-4 and decoder with inference BatchNorm folded in
    and each block ended by the epilogue's plain form, as the scorer runs
    them."""
    import jax.experimental.pallas as pl

    monkeypatch.setattr(encoder_pallas.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    jmodel, variables, tmodel = build_pair(hidden=hidden, layers=layers)
    u8 = np.random.default_rng(7).integers(0, 256, (B, T, SIZE, SIZE * 3), dtype=np.uint8)
    w_band, bias_folded = encoder_pallas.fold_from_variables(variables)
    with jax.default_matmul_precision("highest"):
        jr, je, js, jstates = jmodel.apply(
            variables, jnp.asarray(u8), jax_states(jmodel), jnp.asarray(w_band),
            jnp.asarray(bias_folded), method=JaxVAE.stream_step_u8,
        )
    w, b = fold_from_variables(variables)
    folded = fold_blocks(tmodel.state_dict(), torch.float32)
    tr, te, ts, tstates = tmodel.stream_step_u8(torch.from_numpy(u8),
                                                tmodel.zero_state(B, SIZE, SIZE), w, b, folded)
    assert tr.shape == (B, T, SIZE, SIZE * 3) and te.shape == (B, T, SIZE, SIZE)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **F32)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **F32)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **F32)
    assert_states(tstates, jstates, F32)
    _, none_map, ts2, _ = tmodel.stream_step_u8(
        torch.from_numpy(u8), tmodel.zero_state(B, SIZE, SIZE), w, b, folded,
        compute_err_map=False)
    assert none_map is None
    torch.testing.assert_close(ts2, ts)


def test_stream_step_u8_refuses_stride2():
    _, variables, tmodel = build_pair(stem="stride2", layers=1)
    w, b = fold_from_variables(variables)
    u8 = torch.zeros((1, 1, SIZE, SIZE * 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="stride2"):
        tmodel.stream_step_u8(u8, tmodel.zero_state(1, SIZE, SIZE), w, b,
                              fold_blocks(tmodel.state_dict(), torch.float32))


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_bf16_policy_matches_jax(norm):
    """Serving precision: bf16 weights and activations, f32 (h, c)."""
    jmodel, variables, tmodel = build_pair(norm=norm)
    x = frames(3)
    jr, je, js, jstates = jmodel.apply(
        cast_floating(variables, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), jax_states(jmodel),
        method=JaxVAE.stream_step,
    )
    tmodel.to(torch.bfloat16)
    tr, te, ts, tstates = tmodel.stream_step(torch.from_numpy(x).bfloat16(),
                                             tmodel.zero_state(B, SIZE, SIZE))
    assert ts.dtype == torch.bfloat16
    np.testing.assert_allclose(ts.float().numpy(), np.asarray(js, np.float32), **BF16)
    np.testing.assert_allclose(te.float().numpy(), np.asarray(je, np.float32), **BF16)
    assert_states(tstates, jstates, BF16)


def test_forward_and_reconstruction_error_match_jax():
    jmodel, variables, tmodel = build_pair(hidden=48)
    x = frames(4)
    with jax.default_matmul_precision("highest"):
        jrec = jmodel.apply(variables, jnp.asarray(x), train=False)
        jerr = {k: jmodel.apply(variables, jnp.asarray(x), method=JaxVAE.reconstruction_error,
                                **kw)
                for k, kw in (("seq", {}), ("frame", {"per_frame": True}),
                              ("pixel", {"per_pixel": True}))}
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(tmodel(xt).numpy(), np.asarray(jrec), **F32)
    np.testing.assert_allclose(tmodel.error_map(xt).numpy(), np.asarray(jerr["pixel"]), **F32)
    for k, kw in (("seq", {}), ("frame", {"per_frame": True}), ("pixel", {"per_pixel": True})):
        got = tmodel.reconstruction_error(xt, **kw)
        assert got.shape == jerr[k].shape
        np.testing.assert_allclose(got.numpy(), np.asarray(jerr[k]), **F32)


def test_default_config_parameter_count():
    """The default video model has the reference's 2,709,411 parameters."""
    model = VideoAutoencoder.from_config(VideoAEConfig(), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 2_709_411


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_weight_bridge_round_trip(norm):
    """Every weight lands where the layout rules say: the state dict built
    from the Flax tree equals the tree under the inverse layout maps."""
    _, variables, tmodel = build_pair(hidden=48, norm=norm)
    sd = tmodel.state_dict()
    p = variables["params"]
    kernel = p["convlstm"]["ConvLSTMLayer_0"]["kernel"]
    np.testing.assert_array_equal(
        sd["convlstm.layers.0.w_x"].numpy(), np.transpose(kernel[:, :, :32], (3, 2, 0, 1)))
    np.testing.assert_array_equal(sd["convlstm.layers.0.w_h"].numpy(), kernel[:, :, 32:])
    np.testing.assert_array_equal(
        sd["decoder.deconvs.1.weight"].numpy(),
        np.transpose(p["decoder"]["ConvTranspose_1"]["kernel"][::-1, ::-1], (2, 3, 0, 1)))
    np.testing.assert_array_equal(
        sd["proj.weight"].numpy(), np.transpose(p["proj"]["kernel"], (3, 2, 0, 1)))
    norm_name = "BatchNorm_2" if norm == "batch" else "GroupNorm_2"
    np.testing.assert_array_equal(sd["encoder.norms.2.weight"].numpy(),
                                  p["encoder"][norm_name]["scale"])
    if norm == "batch":
        np.testing.assert_array_equal(sd["decoder.norms.0.running_var"].numpy(),
                                      variables["batch_stats"]["decoder"]["BatchNorm_0"]["var"])
    else:
        assert tmodel.encoder.norms[0].eps == 1e-6  # Flax GroupNorm's eps, not torch's


def test_weight_bridge_fails_loudly():
    _, variables, tmodel = build_pair(layers=1)
    missing = perturbed(variables, np.random.default_rng(0))
    del missing["params"]["decoder"]["ConvTranspose_3"]
    with pytest.raises(KeyError, match="ConvTranspose_3"):
        flax_to_state_dict(tmodel, missing)
    extra = perturbed(variables, np.random.default_rng(0))
    extra["params"]["convlstm"]["ConvLSTMLayer_1"] = {"kernel": np.zeros((3, 3, 64, 128))}
    with pytest.raises(ValueError, match="ConvLSTMLayer_1"):
        flax_to_state_dict(tmodel, extra)
    wrong = perturbed(variables, np.random.default_rng(0))
    wrong["params"]["encoder"]["Conv_1"]["bias"] = np.zeros(65, np.float32)
    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict(tmodel, wrong)


def test_init_weights_is_seeded():
    cfg = VideoAEConfig(latent_dim=32, lstm_hidden_dim=32, lstm_layers=1)
    a = init_weights(VideoAutoencoder.from_config(cfg, device="cpu"), 3)
    b = init_weights(VideoAutoencoder.from_config(cfg, device="cpu"), 3)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
