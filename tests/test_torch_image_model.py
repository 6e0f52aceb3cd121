"""The port's image model (``vad_tpu_torch/models/autoencoder.py``) against
the JAX package's ``ConvAutoencoder``, on the CPU.

Forward in train and eval mode for both stems and both norms (the train
mode's BatchNorm statistics too), the feature pyramid and the anomaly
scores, one ``make_train_step`` step of each package from the same
variables (held against JAX's own step in float64), the weight bridge and
``.ckpt`` files both ways, and the parameter count at full width.  The
variables are a seeded JAX init with biases, scales and norm statistics
moved off identity; inputs come from a numpy seed.  Small sizes: latent
16, 32-48 px images.

Bars: f32 rtol 1e-4 / atol 1e-5; the train step's gradients rtol 5e-4 /
atol 1e-6 (tests/test_torch_training.py's bars; the test's docstring says
what each gradient is held against), bf16 rtol 0.05 / atol 0.02.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_training import (
    BF16,
    F32,
    F64_REL,
    GRAD,
    capture_gradients,
    flax_leaves,
    perturbed,
    rel_l2,
)
from vad_tpu.eval.image_eval import load_image_model as jax_load_image_model
from vad_tpu.models.autoencoder import ConvAutoencoder as JaxAE
from vad_tpu.ops import losses as jlosses
from vad_tpu.train.state import TrainState
from vad_tpu.train.steps import make_train_step as jax_make_train_step
from vad_tpu.train.steps import u8_normalize as jax_u8_normalize
from vad_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from vad_tpu_torch.eval.image_eval import load_image_model
from vad_tpu_torch.models.autoencoder import ConvAutoencoder, same_pad_stride2
from vad_tpu_torch.models.video_autoencoder import init_training_weights
from vad_tpu_torch.ops import losses as tlosses
from vad_tpu_torch.train.steps import make_train_step
from vad_tpu_torch.utils.checkpoint import save_checkpoint
from vad_tpu_torch.utils.weights import (
    flax_to_state_dict,
    load_flax_variables,
    state_dict_to_flax,
)

LATENT = 16
NORMS_STEMS = [("batch", "pool"), ("batch", "stride2"), ("group", "pool"),
               ("group", "stride2")]


def build_pair(norm="batch", stem="pool", size=32, seed=0):
    """(JAX model, perturbed variables, port model in eval mode)."""
    jmodel = JaxAE(latent_dim=LATENT, norm=norm, stem=stem)
    init = jmodel.init(jax.random.key(seed), jnp.zeros((1, size, size, 3)), train=False)
    variables = perturbed(init, np.random.default_rng(seed + 1))
    model = ConvAutoencoder(latent_dim=LATENT, norm=norm, stem=stem, device="cpu")
    return jmodel, variables, load_flax_variables(model, variables).eval()


def images(seed, b=3, size=32):
    return np.random.default_rng(seed).uniform(-1, 1, (b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("norm,stem", NORMS_STEMS)
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(norm, stem, train):
    """Reconstruction in both modes at the f32 bar; in train mode also the
    BatchNorm running statistics after the call.  The stride-2 stem at 48
    px meets an odd 3-pixel map in its last block (JAX pads it (1, 1)).

    In train mode the two f32 forwards each land up to 4.4e-5 (abs) from
    JAX's float64 forward (Flax's one-pass variance, E[x^2] - E[x]^2,
    cancels in f32 and 16 batch-statistics layers amplify it; ROADMAP Queue
    3), so there the port's float64 forward holds the f32 bar against
    JAX's float64 forward (they agree to ~1e-13), and the port's f32
    forward lies no further from it than JAX's f32 forward does."""
    size = 48 if stem == "stride2" else 32
    jmodel, variables, model = build_pair(norm, stem, size)
    x = images(2, size=size)
    with torch.no_grad():
        got = model.train(train)(torch.from_numpy(x)).numpy()
    if not train:
        want = jmodel.apply(variables, jnp.asarray(x), train=False)
        np.testing.assert_allclose(got, np.asarray(want), **F32)
        return
    want, updates = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    stats = flax_leaves(state_dict_to_flax(model)["batch_stats"])
    want_stats = flax_leaves(updates["batch_stats"]) if norm == "batch" else {}
    assert stats.keys() == want_stats.keys()
    for key, value in want_stats.items():
        np.testing.assert_allclose(stats[key], value, **F32, err_msg=key)
    with jax.enable_x64(True):
        variables64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        anchor, _ = jmodel.apply(variables64, jnp.asarray(x, jnp.float64), train=True,
                                 mutable=["batch_stats"])
    anchor = np.asarray(anchor)
    model64 = build_pair(norm, stem, size)[2].double().train()
    with torch.no_grad():
        got64 = model64(torch.from_numpy(x).double()).numpy()
    np.testing.assert_allclose(got64, anchor, **F32)
    assert np.abs(got - anchor).max() <= np.abs(np.asarray(want) - anchor).max() + 1e-6


def test_same_pad_stride2_is_jax_same():
    assert [same_pad_stride2(n) for n in (2, 3, 4, 5, 6, 7)] == [
        (0, 1), (1, 1), (0, 1), (1, 1), (0, 1), (1, 1)]


@pytest.mark.parametrize("norm,stem", [("batch", "pool"), ("group", "stride2")])
def test_pyramid_encode_and_scores_match_jax(norm, stem):
    jmodel, variables, model = build_pair(norm, stem)
    x = images(3)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    with torch.no_grad():
        pyramid = model.feature_pyramid(xt)
        latent = model.encode(xt)
        err_map = model.error_map(xt)
        per_pixel = model.reconstruction_error(xt, per_pixel=True)
        scores = model.reconstruction_error(xt)
    want = jmodel.apply(variables, xj, method=JaxAE.feature_pyramid)
    assert [tuple(f.shape) for f in pyramid] == [f.shape for f in want] == [
        (3, 16, 16, 32), (3, 8, 8, 64), (3, 4, 4, 128), (3, 2, 2, LATENT)]
    for a, b in zip(pyramid, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
    np.testing.assert_allclose(latent.numpy(), np.asarray(want[-1]), **F32)
    np.testing.assert_allclose(
        latent.numpy(), np.asarray(jmodel.apply(variables, xj, method=JaxAE.encode)), **F32)
    np.testing.assert_allclose(
        err_map.numpy(), np.asarray(jmodel.apply(variables, xj, method=JaxAE.error_map)), **F32)
    np.testing.assert_allclose(per_pixel.numpy(), err_map.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jmodel.apply(
        variables, xj, method=JaxAE.reconstruction_error)), **F32)


# ------------------------------------------------------------ train step


def jax_step(jmodel, variables, u8, n_real, accum, dtype):
    state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                              batch_stats=variables.get("batch_stats") or {},
                              tx=capture_gradients())
    step = jax_make_train_step(jlosses.mse_per_sample, preprocess=jax_u8_normalize,
                               compute_dtype=dtype, accum_steps=accum)
    state, loss = step(state, jnp.asarray(u8), jnp.asarray(n_real))
    return float(loss), flax_leaves(state.opt_state), flax_leaves(state.batch_stats)


def port_step(variables, u8, n_real, accum, dtype, norm, stem):
    model = ConvAutoencoder(latent_dim=LATENT, norm=norm, stem=stem, device="cpu")
    load_flax_variables(model, variables)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)  # keeps the weights, leaves .grad
    loss = make_train_step(tlosses.mse_per_sample, dtype, accum_steps=accum)(
        model, opt, torch.from_numpy(u8), n_real)
    grads = ConvAutoencoder(latent_dim=LATENT, norm=norm, stem=stem, device="cpu")
    with torch.no_grad():
        for p, src in zip(grads.parameters(), model.parameters()):
            p.copy_(src.grad)
    return (float(loss), flax_leaves(state_dict_to_flax(grads)["params"]),
            flax_leaves(state_dict_to_flax(model)["batch_stats"]))


@pytest.mark.parametrize("norm,stem,batch,n_real,accum,dtype", [
    ("batch", "pool", 4, 4, 1, None),
    ("group", "stride2", 2, 2, 1, None),
    ("batch", "pool", 4, 3, 1, None),  # padded tail: n_real < batch
    ("batch", "stride2", 8, 8, 2, None),  # gradient accumulation
    ("batch", "pool", 4, 4, 1, "bf16"),
])
def test_train_step_matches_jax(norm, stem, batch, n_real, accum, dtype):
    """Loss, every parameter's gradient and the BatchNorm statistics after
    one step from the same variables and u8 batch, with the float64 anchor
    of ``test_torch_training.test_train_step_matches_jax``: JAX's own step
    with x64 on.  The port's float64 step holds every gradient within 1e-5
    (rel L2) of it.

    The image model's f32 gradients are worse conditioned than the video
    model's (16 normalization layers; BatchNorm's backward subtracts
    per-channel means): both packages' f32 steps land up to 1.2e-2 (rel L2)
    from the anchor at some of these shapes, each at shapes where the other
    holds the gradient bar.  So in f32 each gradient of the port holds the
    gradient bar against the anchor or against JAX's f32 gradient, or lies
    no further from the anchor than JAX's f32 gradient.  In bf16 each lies
    no further from the anchor than 1.5x JAX's bf16 gradient + 0.01 (the
    video test's rule).  A conv bias that feeds a train-mode BatchNorm has
    an exact gradient of 0 and is held to the allclose bar against it."""
    size = 32
    jmodel = JaxAE(latent_dim=LATENT, norm=norm, stem=stem)
    init = jmodel.init(jax.random.key(0), jnp.zeros((1, size, size, 3)), train=False)
    variables = perturbed(init, np.random.default_rng(3))
    u8 = np.random.default_rng(4).integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
    with jax.default_matmul_precision("highest"):
        jloss, jgrads, jstats = jax_step(jmodel, variables, u8, n_real, accum,
                                         jnp.bfloat16 if dtype else None)
    with jax.enable_x64(True):
        variables64 = jax.tree.map(lambda a: a.astype(np.float64), variables)
        _, anchor, _ = jax_step(jmodel, variables64, u8, n_real, accum, jnp.float64)
    loss, grads, stats = port_step(variables, u8, n_real, accum,
                                   torch.bfloat16 if dtype else None, norm, stem)
    _, grads64, _ = port_step(variables, u8, n_real, accum, torch.float64, norm, stem)

    bar = BF16 if dtype else F32
    np.testing.assert_allclose(loss, jloss, **bar)
    assert grads.keys() == jgrads.keys() == anchor.keys() == grads64.keys()
    for key, want in anchor.items():
        if np.abs(want).max() < 1e-12:  # zero by construction: rounding noise
            np.testing.assert_allclose(grads[key], want, **(BF16 if dtype else GRAD),
                                       err_msg=key)
            continue
        assert rel_l2(grads64[key], want) <= F64_REL, key
        if dtype is None:
            assert (np.allclose(grads[key], want, **GRAD)
                    or np.allclose(grads[key], jgrads[key], **GRAD)
                    or rel_l2(grads[key], want) <= rel_l2(jgrads[key], want)), key
        else:
            assert rel_l2(grads[key], want) <= 1.5 * rel_l2(jgrads[key], want) + 0.01, key
    assert stats.keys() == jstats.keys() and (norm == "group") == (not jstats)
    for key in jstats:
        np.testing.assert_allclose(stats[key], jstats[key], **bar, err_msg=key)


# ------------------------------------------------- weights and checkpoints


@pytest.mark.parametrize("norm,stem", [("batch", "pool"), ("group", "stride2")])
def test_weight_bridge_and_checkpoints_both_ways(norm, stem, tmp_path):
    """A JAX ``.ckpt`` loads into the port's ``load_image_model``; the
    port's tree written back is the JAX tree leaf for leaf, and a port
    ``.ckpt`` loads into the JAX ``load_image_model`` with the same
    forward."""
    jmodel, variables, model = build_pair(norm, stem)
    args = {"latent_dim": LATENT, "norm": norm, "stem": stem, "image_size": 32}
    jax_save_checkpoint(tmp_path / "jax.ckpt", {"params": variables["params"],
                                                "batch_stats": variables.get("batch_stats", {}),
                                                "args": args, "epoch": 2, "train_loss": 0.5,
                                                "model_type": "image"})
    loaded, _, saved = load_image_model(tmp_path / "jax.ckpt", "cpu")
    assert saved == args and not loaded.training
    back = state_dict_to_flax(loaded)
    want = flax_leaves(variables)
    assert flax_leaves(back).keys() == want.keys()
    for key, value in flax_leaves(back).items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)

    save_checkpoint(tmp_path / "port.ckpt", {**state_dict_to_flax(model), "args": args,
                                             "epoch": 1, "model_type": "image"})
    jm, jvars, jargs = jax_load_image_model(tmp_path / "port.ckpt")
    x = images(5)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(jvars, jnp.asarray(x), train=False)),
                               **F32)
    assert jargs == args


def test_weight_bridge_fails_loudly():
    _, variables, model = build_pair()
    missing = {"params": dict(variables["params"]), "batch_stats": variables["batch_stats"]}
    missing["params"]["decoder"] = {k: v for k, v in missing["params"]["decoder"].items()
                                    if k != "Conv_0"}
    with pytest.raises(KeyError, match="decoder/Conv_0"):
        flax_to_state_dict(model, missing)
    extra = {**variables, "params": {**variables["params"], "stray": {"kernel": np.zeros(3)}}}
    with pytest.raises(ValueError, match="stray"):
        flax_to_state_dict(model, extra)
    wide = ConvAutoencoder(latent_dim=2 * LATENT, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict(wide, variables)


def test_full_width_parameter_count_and_seeded_init():
    """1,546,147 parameters at the defaults (built without a forward), and
    the training init: seeded, norm scales 1, biases 0, conv kernels with
    Xavier-normal's standard deviation."""
    model = ConvAutoencoder(device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 1_546_147
    small = lambda: ConvAutoencoder(latent_dim=LATENT, device="cpu")  # noqa: E731
    a, b, c = (init_training_weights(small(), s) for s in (7, 7, 8))
    for (name, p), q, r in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(p, q), name
        if p.dim() == 4:
            assert not torch.equal(p, r), name
            fans = p.shape[0] * p[0, 0].numel() + p.shape[1] * p[0, 0].numel()
            assert float(p.detach().std()) == pytest.approx((2.0 / fans) ** 0.5, rel=0.25), name
        else:
            assert torch.all(p == (1.0 if "norm" in name and name.endswith("weight")
                                   else 0.0)), name
