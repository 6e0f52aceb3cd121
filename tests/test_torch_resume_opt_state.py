"""Resuming a JAX checkpoint with the port continues JAX's Adam.

The JAX package builds a ``TrainState``, takes 3 steps of its own
``make_train_step`` on a seeded batch, lowers the learning rate with
``set_learning_rate`` (as its plateau controller does) and saves with its
``save_checkpoint``.  The port's trainers load that file through their
resume path (``resume_state``); then both packages take one more step on
the same batch.  Held: ``exp_avg`` / ``exp_avg_sq`` against ``mu`` / ``nu``
(through the weight bridge's layout maps), each parameter's ``step``
against optax's count, the learning rate, and the parameters, moments and
count after the next step, for the video and the image model.  Last,
``python -m vad_tpu_torch.train_video`` resumes a JAX-written
``checkpoint_epoch_N.ckpt`` that holds ``opt_state`` and carries its step
count on.

Bar: f32 rtol 1e-4 / atol 1e-5.  The next step's moments are compared
after the same gradient (the port's train step's, handed to JAX's
optimizer): JAX's f32 train step lands up to 5.1e-3 rel L2 from its
float64 step (Flax's one-pass BatchNorm variance, ROADMAP Queue 3), which
would be the gradients' difference, not the optimizers'.  The parameters
are also held against JAX's own full step.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vad_tpu.models.autoencoder import ConvAutoencoder as JaxAE
from vad_tpu.models.video_autoencoder import VideoAutoencoder as JaxVAE
from vad_tpu.ops import losses as jlosses
from vad_tpu.train.state import create_train_state
from vad_tpu.train.state import current_learning_rate as jax_lr
from vad_tpu.train.state import set_learning_rate as jax_set_lr
from vad_tpu.train.steps import make_train_step as jax_make_train_step
from vad_tpu.train.steps import u8_normalize
from vad_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from vad_tpu_torch.models.autoencoder import ConvAutoencoder
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
from vad_tpu_torch.ops import losses as tlosses
from vad_tpu_torch.train.state import current_learning_rate, make_optimizer
from vad_tpu_torch.train.steps import make_train_step
from vad_tpu_torch.train.video_trainer import resume_state
from vad_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint
from vad_tpu_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

F32 = dict(rtol=1e-4, atol=1e-5)
LR, REDUCED_LR, STEPS = 1e-3, 5e-4, 3
VIDEO = dict(latent_dim=16, lstm_hidden_dim=16, lstm_layers=1)
SIZE, T, B = 32, 3, 2


def jax_models(kind):
    if kind == "video":
        return (JaxVAE(backend="xla", **VIDEO), (1, 2, SIZE, SIZE, 3),
                (B, T, SIZE, SIZE, 3))
    return JaxAE(latent_dim=16), (1, SIZE, SIZE, 3), (B, SIZE, SIZE, 3)


def port_model(kind):
    if kind == "video":
        return VideoAutoencoder(device="cpu", **VIDEO)
    return ConvAutoencoder(latent_dim=16, device="cpu")


@functools.lru_cache(maxsize=None)
def jax_trained(kind):
    """(JAX state after STEPS steps with the learning rate then lowered,
    its compiled train step, the batch)."""
    jmodel, init_shape, batch_shape = jax_models(kind)
    variables = jmodel.init(jax.random.key(0), jnp.zeros(init_shape), train=False)
    state = create_train_state(jmodel, variables, LR, weight_decay=1e-5)
    step = jax_make_train_step(jlosses.mse_per_sample, preprocess=u8_normalize)
    u8 = np.random.default_rng(5).integers(0, 256, batch_shape, dtype=np.uint8)
    with jax.default_matmul_precision("highest"):
        for _ in range(STEPS):
            state, _ = step(state, jnp.asarray(u8), jnp.asarray(B))
    return jax_set_lr(state, REDUCED_LR), step, u8


def jax_run(kind, path, epoch=1):
    """``jax_trained(kind)`` saved to ``path`` by the JAX package's
    ``save_checkpoint``, as its trainer saves a best checkpoint."""
    state, step, u8 = jax_trained(kind)
    jax_save_checkpoint(path, {"epoch": epoch, "params": state.params,
                               "batch_stats": state.batch_stats, "opt_state": state.opt_state,
                               "separation": 1.0, "args": {}, "model_type": kind})
    return state, step, u8


def noise_gradient_biases(model):
    """Conv biases that feed a train-mode BatchNorm: the norm subtracts the
    batch mean, so their exact gradient is zero, a computed one is rounding
    noise, and Adam turns that noise into steps of the learning rate's
    size."""
    if isinstance(model, VideoAutoencoder):
        return ({f"encoder.convs.{i}.bias" for i in range(len(model.encoder.convs))}
                | {f"decoder.deconvs.{i}.bias" for i in range(len(model.decoder.norms))})
    return {n for n, _ in model.named_parameters()
            if n.endswith(".bias") and "norm" not in n and n != "decoder.conv.bias"}


def adam_leaves(state):
    adam = state.opt_state.inner_state[1]
    return int(adam.count), adam.mu, adam.nu


def port_moments(model, optimizer):
    """(exp_avg, exp_avg_sq, steps) keyed by parameter name."""
    st = optimizer.state_dict()["state"]
    names = [n for n, _ in model.named_parameters()]
    return ({n: st[i]["exp_avg"] for i, n in enumerate(names)},
            {n: st[i]["exp_avg_sq"] for i, n in enumerate(names)},
            {float(st[i]["step"]) for i in range(len(names))})


def assert_matches_jax(model, optimizer, state, bar):
    count, mu, nu = adam_leaves(state)
    exp_avg, exp_avg_sq, steps = port_moments(model, optimizer)
    stats = jax.tree.map(np.asarray, state.batch_stats)
    for got, tree in ((exp_avg, mu), (exp_avg_sq, nu)):
        want = flax_to_state_dict(model, {"params": jax.tree.map(np.asarray, tree),
                                          "batch_stats": stats})
        for name, value in got.items():
            np.testing.assert_allclose(value.numpy(), want[name].numpy(), err_msg=name, **bar)
    assert steps == {float(count)}
    params = flax_to_state_dict(model, {"params": jax.tree.map(np.asarray, state.params),
                                        "batch_stats": stats})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[name].numpy(), err_msg=name,
                                   **bar)


@pytest.mark.parametrize("kind", ["video", "image"])
def test_resume_continues_jax_adam(kind, tmp_path, capsys):
    path = tmp_path / "best_model.ckpt"
    state, jstep, u8 = jax_run(kind, path)
    model = port_model(kind)
    optimizer = make_optimizer(model.parameters(), LR, weight_decay=1e-5)
    resume_state(model, optimizer, load_checkpoint(path))
    assert "Adam moments restart" not in capsys.readouterr().out
    assert current_learning_rate(optimizer) == jax_lr(state) == np.float32(REDUCED_LR)
    assert_matches_jax(model, optimizer, state, dict(rtol=0, atol=0))  # a copy, exact

    # the port's next train step; JAX's optimizer takes the same gradient
    make_train_step(tlosses.mse_per_sample)(model, optimizer, torch.from_numpy(u8), B)
    grads = copy.deepcopy(model)
    with torch.no_grad():
        for g, p in zip(grads.parameters(), model.parameters()):
            g.copy_(p.grad)
    stepped = jax.jit(lambda st, g: st.apply_gradients(grads=g))(
        state, state_dict_to_flax(grads)["params"])
    assert_matches_jax(model, optimizer, stepped, F32)

    # and JAX's own full train step: every parameter but the noise-gradient
    # biases (held above on one gradient)
    with jax.default_matmul_precision("highest"):
        jstate, _ = jstep(jax.tree.map(jnp.copy, state), jnp.asarray(u8), jnp.asarray(B))
    want = flax_to_state_dict(model, {"params": jax.tree.map(np.asarray, jstate.params),
                                      "batch_stats": jax.tree.map(np.asarray,
                                                                  jstate.batch_stats)})
    skip = noise_gradient_biases(model)
    assert skip and skip < {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        if name not in skip:
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), err_msg=name,
                                       **F32)
    assert port_moments(model, optimizer)[2] == {float(STEPS + 1)}


def test_resume_without_opt_state_restarts(tmp_path, capsys):
    state, _, _ = jax_run("video", tmp_path / "m.ckpt")
    ckpt = load_checkpoint(tmp_path / "m.ckpt")
    ckpt["opt_state"] = None
    model = port_model("video")
    optimizer = make_optimizer(model.parameters(), LR)
    resume_state(model, optimizer, ckpt)
    assert "Adam moments restart" in capsys.readouterr().out
    assert optimizer.state_dict()["state"] == {} and current_learning_rate(optimizer) == LR


def test_cli_resumes_a_jax_epoch_checkpoint(synthetic_video_root, tmp_path, capsys):
    """``train_video --resume`` on the newest JAX-written per-epoch
    checkpoint: no restart line, JAX's learning rate, and Adam's step count
    carried on through the next epoch."""
    from vad_tpu_torch import train_video

    run = tmp_path / "video_S01_jax"
    run.mkdir()
    base = ["--category", "S01", "--data-dir", synthetic_video_root, "--device", "cpu",
            "--image-size", str(SIZE), "--sequence-length", str(T), "--stride", "8",
            "--batch-size", str(B), "--num-workers", "0", "--latent-dim", "16",
            "--lstm-hidden-dim", "16", "--lstm-layers", "1"]
    jax_run("video", run / "checkpoint_epoch_1.ckpt", epoch=1)
    jax_run("video", run / "checkpoint_epoch_2.ckpt", epoch=2)
    path = latest_checkpoint(run)
    assert path == run / "checkpoint_epoch_2.ckpt"
    capsys.readouterr()
    train_video.main(base + ["--epochs", "3", "--lr", str(LR), "--resume", str(path)])
    out = capsys.readouterr().out
    assert "Adam moments restart" not in out and "Resumed from" in out
    assert f"step {STEPS}, lr {np.float32(REDUCED_LR):g}" in out
    final = load_checkpoint(run / "final_model.ckpt")
    n_steps = -(-len(train_video_windows(synthetic_video_root)) // B)
    steps = {float(s["step"]) for s in final["torch_opt_state"]["state"].values()}
    assert steps == {float(STEPS + n_steps)}
    assert final["torch_opt_state"]["param_groups"][0]["lr"] == pytest.approx(REDUCED_LR)


def train_video_windows(root):
    from vad_tpu_torch.data.video_dataset import IPADDataset

    return IPADDataset(root, "S01", "train", sequence_length=T, stride=8, image_size=SIZE,
                       normalize=False)
