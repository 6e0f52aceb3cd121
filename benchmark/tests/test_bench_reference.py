"""The plain reference against the port's CPU path at a tiny size (the
test may import the port; the reference may not)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import scene
from benchmark.manifest import Manifest
from benchmark.reference import video_ae as ref
from benchmark.weights import make_weights, program_state_dict

CFG = {"reference": "reference/video_ae.py", "in_channels": 3, "latent_dim": 16,
       "lstm_hidden_dim": 16, "lstm_layers": 2, "image_size": 32, "sequence_length": 4,
       "norm": "batch", "stem": "pool"}
M = Manifest()
MINE = [c["name"] for c in M.data["configs"]
        if M.config(c["name"]).get("reference") == "reference/video_ae.py"]


@pytest.mark.parametrize("name", MINE)
def test_each_configuration_of_this_model_fits_its_four_pools(name):
    assert M.config(name)["image_size"] % 16 == 0


def _port_model(weights, cfg=CFG):
    from vad_tpu_torch.core.config import VideoAEConfig
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder

    model = VideoAutoencoder.from_config(VideoAEConfig.from_args(cfg), device="cpu")
    model.load_state_dict(program_state_dict(weights))
    return model


def test_reference_imports_nothing_of_the_program():
    for path in Path(ref.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not [n for n in names if n.split(".")[0] in ("vad_tpu_torch", "vad_tpu", "jax",
                                                            "flax", "benchmark")], path


def test_layout_is_the_port_state_dict():
    sd = _port_model(make_weights(CFG, 1, "cpu")).state_dict()
    assert {k for k in sd if not k.endswith("num_batches_tracked")} == {
        k for k, _ in ref.layout(CFG)}
    assert all(tuple(sd[k].shape) == s for k, s in ref.layout(CFG))


@pytest.mark.parametrize("hidden", [16, 24])  # 24: the 1x1 projection
def test_streaming_chunks_match_the_port(hidden):
    from vad_tpu_torch.eval.serving import MultiStreamScorer

    cfg = dict(CFG, lstm_hidden_dim=hidden)
    w = make_weights(cfg, 3, "cpu")
    scorer = MultiStreamScorer(_port_model(w, cfg), None, num_slots=3, chunk=4, image_size=32,
                               dtype=torch.float32, fused_input=False, device="cpu")
    for s in range(3):
        scorer.attach(s)
    states = ref.zero_states(cfg, 3, (32, 32), "cpu")
    pool = scene.stream_pool(5, 3, 2, 4, 32)
    for k in range(3):
        got = scorer.score_chunk(pool[k % 2])
        want, states = ref.score_chunk(w, torch.as_tensor(pool[k % 2]), states, ref.Numerics())
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-6)
    for (h, c), (rh, rc) in zip(scorer.states, states):
        torch.testing.assert_close(h, rh, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(c, rc, rtol=1e-4, atol=1e-5)


def test_train_steps_match_the_port():
    """Losses and first gradients closely; the parameters after three Adam
    steps by the worst leaf's gap of change norms (elementwise, Adam
    amplifies the gradients' rounding where they are small)."""
    from vad_tpu_torch.ops.losses import make_per_sample_loss_fn
    from vad_tpu_torch.train.state import make_optimizer
    from vad_tpu_torch.train.steps import make_train_step

    from benchmark import judge

    w = make_weights(CFG, 4, "cpu")
    model = _port_model(w)
    opt = make_optimizer(model.parameters(), 1e-3, weight_decay=1e-5)
    step = make_train_step(make_per_sample_loss_fn("mse"))
    pool = torch.from_numpy(scene.stream_pool(6, 6, 1, 4, 32)[0]).reshape(3, 2, 4, 32, 32, 3)
    losses = [float(step(model, opt, pool[0], 2))]
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    losses += [float(step(model, opt, pool[k], 2)) for k in (1, 2)]
    want_losses, want_grads, params = ref.train_steps(w, list(pool), CFG, 1e-3, 1e-5)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    moved = list(judge.moved_leaves(want_grads))
    assert len(moved) == len(want_grads) - 7  # the 7 biases ahead of a BatchNorm
    for k in moved:
        assert float((grads[k] - want_grads[k]).norm() / want_grads[k].norm()) < 1e-4, k
    got = dict(model.named_parameters())
    change = {k: got[k].detach() - w[k] for k in moved}
    # a leaf whose gradients are small next to their rounding moves by
    # Adam's unit steps in directions the rounding picks: a few 1e-3 here
    assert judge.norm_gap(change, {k: params[k] - w[k] for k in moved}, moved) < 1e-2


def test_scene_is_the_port_generator():
    from vad_tpu_torch.data import synthetic

    phase, speed = scene.stream_motion(7, 2)
    frames = scene.chunk_frames(7, 2, 1, 4, 64)
    rng = np.random.default_rng(0)
    for k in range(4):
        if not (1 <= k < 3):  # frames without an intruder
            want = synthetic._video_frame(4 + k, 64, phase, speed, False, rng)
            np.testing.assert_array_equal(frames[k], want)
