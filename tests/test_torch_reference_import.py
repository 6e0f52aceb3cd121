"""Reference (PyTorch) checkpoints both ways with the port
(``vad_tpu_torch/utils/torch_import.py``), against the JAX package's
importer and the reference-architecture oracles of
``tests/test_torch_import.py``, on the CPU.

The oracles carry the reference's module names and forward; their weights
are drawn from torch's seeded init with BatchNorm statistics off identity
(numpy seed), at latent 16 / hidden 16 and 64x64 (32x32 for the video).
The f32 parity bar is rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_import import TorchImageOracle, TorchVideoOracle, _randomize_bn_stats
from vad_tpu.utils import torch_import as jax_import
from vad_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from vad_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from vad_tpu_torch.models.autoencoder import ConvAutoencoder
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_weights
from vad_tpu_torch.utils import torch_import
from vad_tpu_torch.utils.checkpoint import load_checkpoint
from vad_tpu_torch.utils.weights import flax_to_state_dict, state_dict_to_flax

F32 = dict(rtol=1e-4, atol=1e-5)
LATENT = 16


def _oracle(kind, seed=0):
    torch.manual_seed(seed)
    model = (TorchVideoOracle(latent=LATENT, hidden=LATENT) if kind == "video"
             else TorchImageOracle(latent=LATENT))
    _randomize_bn_stats(model, np.random.default_rng(seed))
    return model.eval()


def _input(kind, seed=1):
    rng = np.random.default_rng(seed)
    shape = (2, 3, 32, 32, 3) if kind == "video" else (2, 64, 64, 3)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.5)


def _oracle_forward(oracle, kind, x):
    """The oracle on NHWC input, back to NHWC."""
    with torch.no_grad():
        if kind == "video":
            return oracle(x.permute(0, 1, 4, 2, 3)).permute(0, 1, 3, 4, 2)
        return oracle(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("kind", ("image", "video"))
def test_import_equals_jax_import(kind):
    """The port's import of a reference state_dict is JAX's, array for array."""
    sd = _oracle(kind).state_dict()
    ours = getattr(torch_import, f"import_{kind}_state_dict")(sd)
    theirs = getattr(jax_import, f"import_{kind}_state_dict")(sd)
    for mine, jax_tree in zip(ours, theirs):
        a, b = _leaves(mine), _leaves(jax_tree)
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("kind", ("image", "video"))
def test_export_equals_jax_export(kind):
    """The other way: a variables tree to reference names, as JAX names it."""
    params, stats = getattr(jax_import, f"import_{kind}_state_dict")(_oracle(kind).state_dict())
    ours = getattr(torch_import, f"export_{kind}_state_dict")(params, stats)
    theirs = getattr(jax_import, f"export_{kind}_state_dict")(params, stats)
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)


@pytest.mark.parametrize("kind", ("image", "video"))
def test_reference_weights_score_as_the_oracle(kind):
    """``reference_state_dict_to_port`` loads with ``strict=True`` into the
    port's model (the fused gate conv split into ``w_x``/``w_h``), whose
    forward equals the reference oracle's at the f32 bar."""
    oracle = _oracle(kind)
    model = torch_import.port_model_for(oracle.state_dict(), "cpu").eval()
    model.load_state_dict(torch_import.reference_state_dict_to_port(oracle.state_dict()),
                          strict=True)
    x = _input(kind)
    with torch.no_grad():
        got = model(x)
    np.testing.assert_allclose(got.numpy(), _oracle_forward(oracle, kind, x).numpy(), **F32)


@pytest.mark.parametrize("kind", ("image", "video"))
def test_port_weights_load_into_the_oracle(kind):
    """``port_to_reference_state_dict`` loads with ``strict=True`` into the
    reference's modules, which then score as the port does."""
    if kind == "video":
        model = init_weights(VideoAutoencoder(latent_dim=LATENT, lstm_hidden_dim=LATENT,
                                              device="cpu"), 2)
    else:
        model = init_weights(ConvAutoencoder(latent_dim=LATENT, device="cpu"), 2)
    model.eval()
    oracle = _oracle(kind)
    oracle.load_state_dict(torch_import.port_to_reference_state_dict(model), strict=True)
    x = _input(kind)
    with torch.no_grad():
        got = model(x)
    np.testing.assert_allclose(_oracle_forward(oracle, kind, x).numpy(), got.numpy(), **F32)


def test_jax_exported_state_dict_loads_into_the_port():
    """JAX's ``export_video_state_dict`` output loads into the port with
    ``strict=True`` and gives back the variables it came from."""
    model = init_weights(VideoAutoencoder(latent_dim=LATENT, lstm_hidden_dim=LATENT,
                                          device="cpu"), 3)
    tree = state_dict_to_flax(model)
    sd = {k: torch.tensor(np.asarray(v))
          for k, v in jax_import.export_video_state_dict(tree["params"],
                                                         tree["batch_stats"]).items()}
    port = torch_import.port_model_for(sd)
    port.load_state_dict(torch_import.reference_state_dict_to_port(sd), strict=True)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(port.state_dict()[key], value, rtol=0, atol=0, msg=key)


def test_gate_split_and_decoder_layouts():
    """The fused gate conv ``[4H, I+H, 3, 3]`` splits at input channel I
    into ``w_x [4H, I, 3, 3]`` and ``w_h [3, 3, H, 4H]``; a reference
    ConvTranspose2d weight reaches the port's unchanged (both torch's)."""
    sd = _oracle("video").state_dict()
    port = torch_import.reference_state_dict_to_port(sd)
    fused = sd["convlstm.cells.0.conv.weight"]
    torch.testing.assert_close(port["convlstm.layers.0.w_x"], fused[:, :LATENT],
                               rtol=0, atol=0)
    torch.testing.assert_close(port["convlstm.layers.0.w_h"],
                               fused[:, LATENT:].permute(2, 3, 1, 0), rtol=0, atol=0)
    for i in range(4):
        torch.testing.assert_close(port[f"decoder.deconvs.{i}.weight"],
                                   sd[f"decoder.decoder.{3 * i}.weight"], rtol=0, atol=0)


@pytest.mark.parametrize("kind", ("image", "video"))
def test_cli_both_ways_match_jax(kind, tmp_path):
    """``python -m vad_tpu_torch.utils.torch_import``: the ``.ckpt`` it
    writes from a ``.pth`` holds JAX's import, and its ``--export`` of that
    ``.ckpt`` loads into the oracle with ``strict=True`` and scores as the
    oracle it came from."""
    oracle = _oracle(kind)
    pth = tmp_path / "best_model.pth"
    torch.save({"epoch": 3, "model_state_dict": oracle.state_dict(), "train_loss": 0.5,
                "args": {"latent_dim": LATENT}}, str(pth))
    ours, back = tmp_path / "ours.ckpt", tmp_path / "back.pth"
    torch_import.main(["--checkpoint", str(pth), "--out", str(ours), "--device", "cpu"])
    theirs = jax_import.import_torch_checkpoint(str(pth))
    mine = load_checkpoint(ours)
    assert (mine["model_type"], mine["epoch"], mine["args"]) == (kind, 3, {"latent_dim": LATENT})
    a = _leaves({"params": mine["params"], "batch_stats": mine["batch_stats"]})
    b = _leaves({"params": theirs["params"], "batch_stats": theirs["batch_stats"]})
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    # the JAX package reads the port's .ckpt, and the port serves it
    jax_tree = jax_load_checkpoint(ours)
    assert _leaves(jax_tree["params"]).keys() == _leaves(mine["params"]).keys()
    model = torch_import.port_model_for(oracle.state_dict())
    flax_to_state_dict(model, {"params": mine["params"], "batch_stats": mine["batch_stats"]})

    torch_import.main(["--checkpoint", str(ours), "--out", str(back), "--export",
                       "--device", "cpu"])
    payload = torch.load(str(back), weights_only=True)
    fresh = _oracle(kind, seed=9)
    fresh.load_state_dict(payload["model_state_dict"], strict=True)
    x = _input(kind)
    np.testing.assert_allclose(_oracle_forward(fresh, kind, x).numpy(),
                               _oracle_forward(oracle, kind, x).numpy(), **F32)


def test_export_of_a_jax_checkpoint_matches_jax(tmp_path):
    """``--export`` of a ``.ckpt`` the JAX package wrote gives JAX's ``.pth``."""
    model = init_weights(ConvAutoencoder(latent_dim=LATENT, device="cpu"), 4)
    ckpt = tmp_path / "best_model.ckpt"
    jax_save_checkpoint(ckpt, {**state_dict_to_flax(model), "epoch": 2, "train_loss": 0.1,
                               "args": {"latent_dim": LATENT}})
    ours, theirs = tmp_path / "ours.pth", tmp_path / "theirs.pth"
    torch_import.export_torch_checkpoint(ckpt, ours)
    jax_import.export_torch_checkpoint(ckpt, theirs)
    a, b = (torch.load(str(p), weights_only=True) for p in (ours, theirs))
    assert a.keys() == b.keys() and a["epoch"] == b["epoch"] == 2
    assert a["model_state_dict"].keys() == b["model_state_dict"].keys()
    for key, value in a["model_state_dict"].items():
        torch.testing.assert_close(value, b["model_state_dict"][key], rtol=0, atol=0, msg=key)


def test_group_norm_checkpoint_is_refused():
    model = VideoAutoencoder(latent_dim=LATENT, lstm_hidden_dim=LATENT, norm="group",
                             device="cpu")
    with pytest.raises(ValueError, match="batch_stats"):
        torch_import.port_to_reference_state_dict(model)


def test_detect_model_type():
    assert torch_import.detect_model_type({"convlstm.cells.0.conv.weight": 0}) == "video"
    assert torch_import.detect_model_type({"encoder.enc1.0.weight": 0}) == "image"


def test_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_import.main(["--checkpoint", "x.pth", "--out", str(tmp_path / "y.ckpt")])
