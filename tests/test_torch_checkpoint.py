"""Checkpoints, imports and devices of the PyTorch port.

A ``.ckpt`` written by the JAX package (with a real optax optimizer state)
must load through the port's restricted reader without optax or JAX; the
port must import no JAX-side module at all; and its entry points must
refuse to run when asked for a CUDA device that is not there.
"""

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vad_tpu.core.config import ImageAEConfig as JaxImageConfig
from vad_tpu.core.config import VideoAEConfig as JaxVideoConfig
from vad_tpu.models.video_autoencoder import ConvLSTM as JaxConvLSTM
from vad_tpu.models.video_autoencoder import VideoAutoencoder as JaxVAE
from vad_tpu.train.state import make_optimizer
from vad_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from vad_tpu_torch.core.config import ImageAEConfig, VideoAEConfig
from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.eval.serving import MultiStreamScorer
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
from vad_tpu_torch.utils.checkpoint import (
    OptaxState,
    load_checkpoint,
    load_checkpoint_bytes,
    save_checkpoint,
)
from vad_tpu_torch.utils.precision import cast_floating, checked_cast_like
from vad_tpu_torch.utils.weights import load_flax_variables

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vad_tpu")


def _run(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def _forbidden_loaded_expr() -> str:
    return ("[m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]")


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A small video model's checkpoint as the JAX trainer writes it."""
    model = JaxVAE(latent_dim=32, lstm_hidden_dim=32, lstm_layers=1)
    variables = model.init(jax.random.key(0), jnp.zeros((1, 2, 32, 32, 3)), train=False)
    opt_state = make_optimizer(1e-3).init(variables["params"])
    path = tmp_path_factory.mktemp("ckpt") / "best_model.ckpt"
    cfg = JaxVideoConfig(latent_dim=32, lstm_hidden_dim=32, lstm_layers=1, image_size=32)
    jax_save_checkpoint(path, {
        "params": variables["params"], "batch_stats": variables["batch_stats"],
        "opt_state": opt_state, "epoch": 3, "args": cfg.to_dict(),
    })
    return path, model, variables


def test_jax_checkpoint_loads_without_optax_or_jax(jax_checkpoint):
    path, _, variables = jax_checkpoint
    code = f"""
import json, sys
import numpy as np
from vad_tpu_torch.utils.checkpoint import load_checkpoint
ck = load_checkpoint({str(path)!r})
names = []
def walk(x):
    if isinstance(x, tuple):
        names.append(type(x).__name__)
        for v in x: walk(v)
    elif isinstance(x, dict):
        for v in x.values(): walk(v)
walk(ck["opt_state"])
leaves = [ck["params"]["encoder"]["Conv_0"]["kernel"],
          ck["batch_stats"]["encoder"]["BatchNorm_0"]["var"]]
total = float(sum(np.abs(a).sum() for a in leaves))
print(json.dumps({{"forbidden": {_forbidden_loaded_expr()}, "names": sorted(set(names)),
                  "epoch": ck["epoch"], "args": ck["args"], "total": total}}))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == []
    assert "ScaleByAdamState" in out["names"]
    assert out["epoch"] == 3 and out["args"]["lstm_hidden_dim"] == 32
    leaves = [variables["params"]["encoder"]["Conv_0"]["kernel"],
              variables["batch_stats"]["encoder"]["BatchNorm_0"]["var"]]
    want = float(sum(np.abs(np.asarray(a)).sum() for a in leaves))
    assert out["total"] == pytest.approx(want, rel=1e-6)


def test_jax_checkpoint_drives_the_port(jax_checkpoint):
    """.ckpt -> port model -> same stream_step output as the JAX model."""
    path, model, variables = jax_checkpoint
    ck = load_checkpoint(path)
    cfg = VideoAEConfig.from_args(ck["args"])
    tmodel = VideoAutoencoder.from_config(cfg, device="cpu").eval()
    load_flax_variables(tmodel, {"params": ck["params"], "batch_stats": ck["batch_stats"]})
    x = np.random.default_rng(0).uniform(-1, 1, (1, 2, 32, 32, 3)).astype(np.float32)
    states = JaxConvLSTM.zero_state(1, 1, 2, 2, 32)
    with jax.default_matmul_precision("highest"):
        _, _, jscores, _ = model.apply(variables, jnp.asarray(x), states,
                                       method=JaxVAE.stream_step)
    with torch.no_grad():
        _, _, tscores, _ = tmodel.stream_step(torch.from_numpy(x), tmodel.zero_state(1, 32, 32))
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), rtol=1e-4, atol=1e-5)
    opt = ck["opt_state"]
    assert isinstance(opt, OptaxState)
    assert type(opt).__name__ in ("InjectHyperparamsState", "InjectStatefulHyperparamsState")


def test_import_pulls_in_no_jax_side_module():
    code = f"""
import importlib, json, pkgutil, sys
import vad_tpu_torch
for m in pkgutil.walk_packages(vad_tpu_torch.__path__, "vad_tpu_torch."):
    importlib.import_module(m.name)
print(json.dumps({_forbidden_loaded_expr()}))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_restricted_reader_refuses_code(tmp_path):
    marker = tmp_path / "pwned"

    class Payload:
        def __reduce__(self):
            return (os.system, (f"touch {marker}",))

    evil = tmp_path / "evil.ckpt"
    evil.write_bytes(pickle.dumps(Payload()))
    with pytest.raises(pickle.UnpicklingError, match="disallowed global"):
        load_checkpoint(evil)
    with pytest.raises(pickle.UnpicklingError, match="disallowed global"):
        load_checkpoint_bytes(pickle.dumps({"x": Payload()}))
    assert not marker.exists()


def test_port_checkpoint_round_trip(tmp_path):
    payload = {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "epoch": 1,
               "args": {"latent_dim": 32}}
    path = save_checkpoint(tmp_path / "m.ckpt", payload)
    back = load_checkpoint(path)
    np.testing.assert_array_equal(back["params"]["w"], np.arange(6.0).reshape(2, 3))
    assert back["epoch"] == 1 and back["args"] == {"latent_dim": 32}
    with pytest.raises(ValueError, match="opt_state"):
        save_checkpoint(tmp_path / "o.ckpt", {"opt_state": OptaxState(1, 2)})


@pytest.mark.parametrize("args", [{}, {"latent_dim": 64, "norm": "group", "stem": "stride2",
                                       "lstm_layers": "3", "image_size": 128}])
def test_configs_match_jax(args):
    assert VideoAEConfig.from_args(args).to_dict() == JaxVideoConfig.from_args(args).to_dict()
    assert ImageAEConfig.from_args(args).to_dict() == JaxImageConfig.from_args(args).to_dict()


def test_checked_cast_like():
    ref = {"a": torch.zeros(2, dtype=torch.bfloat16), "n": torch.zeros((), dtype=torch.int64)}
    new = checked_cast_like({"a": torch.ones(2), "n": torch.ones((), dtype=torch.int64)}, ref,
                            torch.bfloat16)
    assert new["a"].dtype == torch.bfloat16 and new["n"].dtype == torch.int64
    with pytest.raises(ValueError, match="does not match"):
        checked_cast_like({"a": torch.ones(3), "n": torch.ones(())}, ref, torch.bfloat16)
    assert cast_floating({"x": {"y": torch.ones(1)}}, torch.bfloat16)["x"]["y"].dtype \
        == torch.bfloat16


def test_entry_points_refuse_missing_cuda(monkeypatch):
    """device=None means CUDA: with none present every entry point raises
    rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VideoAutoencoder(latent_dim=32, lstm_hidden_dim=32, lstm_layers=1)
    model = VideoAutoencoder(latent_dim=32, lstm_hidden_dim=32, lstm_layers=1, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MultiStreamScorer(model, None, 2, 2, 32)
    assert resolve_device("cpu") == torch.device("cpu")
