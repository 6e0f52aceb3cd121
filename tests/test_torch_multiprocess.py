"""REAL multi-process runs of the port on the CPU (gloo).

- ``python -m vad_tpu_torch.parallel.multiprocess_check`` in both forms:
  the image model data-parallel (16x16, B=16, as JAX's check) and the
  cross-process tensor parallelism of the video model's gate weights
  (``--model-parallel 2``, the model group spanning both processes); each
  against its 1-process control and a float64 step
  (``tests/test_multiprocess.py``'s counterpart).
- The trainers' entry points (``tests/test_train_tp.py``'s counterpart):
  ``python -m vad_tpu_torch.train`` and ``... train_video`` as 2-process
  runs under torchrun's environment, ``--model-parallel 2`` against
  ``--model-parallel 1``: the same loss and separation trajectories at
  JAX's rtol 3e-3, the same best epoch, and best checkpoints whose weights
  agree at JAX's bars.
- ``--resume`` of a JAX checkpoint with its optax state under
  ``--model-parallel 2``: each rank slices the full tree (weights and
  Adam's moments), and the next epoch equals a 1-process resume.

Every spawn has its own timeout, so a hung rendezvous fails the test
instead of running into the suite's clock."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vad_tpu_torch.parallel.multiprocess_check import launch
from vad_tpu_torch.utils.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 300.0


@pytest.mark.parametrize("model_parallel", [1, 2], ids=["dp", "cross-process-tp"])
def test_two_process_training_matches_single_process(model_parallel, tmp_path):
    result = launch(processes=2, steps=2, out_dir=str(tmp_path), timeout=TIMEOUT,
                    model_parallel=model_parallel, device="cpu")
    assert result["ok"] and result["backend"] == "gloo"
    assert len(result["multiproc_losses"]) == 2
    assert result["checkpoint"]["compared"] > 0
    for p in range(2):
        rec = json.loads((tmp_path / "multiproc" / f"proc{p}.json").read_text())
        assert rec["process_count"] == 2
        assert rec["mesh"] == ({"data": 2, "model": 1} if model_parallel == 1
                               else {"data": 1, "model": 2})
        # under tp every gate parameter of the video model is sliced
        assert len(rec["sliced"]) == (3 if model_parallel == 2 else 0)


def _adam_like_run(grad, w0, lr=1e-3, scale=1.0):
    """A first step of ~lr * sign(g), its effective gradient ``grad``."""
    return {"grad": {"w": grad}, "states": [{"w": w0 - scale * lr * np.sign(grad)}]}


@pytest.mark.parametrize("fault", ["none", "skipped", "halved", "flipped_element"])
def test_judge_training_catches_a_botched_update(fault):
    """``judge_training`` (the rule of the check and of the card's scaling
    phase) passes a run equal to the control's up to rounding, and fails an
    update skipped or halved on a rank, and a wrong gradient element whose
    wrong weight would otherwise be waived by its own error."""
    from vad_tpu_torch.parallel.multiprocess_check import judge_training

    rng = np.random.default_rng(0)
    w0, exact = rng.normal(size=256), rng.normal(size=256)
    control_grad = exact + 1e-7 * rng.normal(size=256)
    control = _adam_like_run(control_grad, w0)
    got_grad = control_grad + 1e-7 * rng.normal(size=256)
    got = _adam_like_run(got_grad, w0, scale={"skipped": 0.0, "halved": 0.5}.get(fault, 1.0))
    if fault == "flipped_element":
        i = int(np.argmax(np.abs(exact)))
        got_grad[i] = -got_grad[i]
        got = _adam_like_run(got_grad, w0)
    for f32 in (True, False):
        record = judge_training(got, control, {"w": exact}, {"w": w0}, set(), f32=f32)
        if fault == "none" or (fault == "flipped_element" and not f32):
            # one flipped element of 256 moves the update by 1/8 rel L2
            assert record["ok"], record
        else:
            assert not record["ok"] and any("update" in f or "after step" in f
                                            or "gradient" in f for f in record["failed"])
    if fault == "flipped_element":
        failed = judge_training(got, control, {"w": exact}, {"w": w0}, set())["failed"]
        assert "gradient of w" in failed and "w after step 1" in failed


def test_kink_pattern_replays_each_kink():
    """``KinkPattern`` records the sign of each (leaky) ReLU input and each
    2x2 max-pool winner, and a replay computes every call through the
    pattern: where it differs from the input's own kinks, the flipped
    element follows the pattern, forward and backward."""
    import torch
    import torch.nn.functional as F

    from vad_tpu_torch.parallel.multiprocess_check import KinkPattern

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 4, 4, generator=gen, dtype=torch.float64)

    def step(x):
        return F.relu(x) + F.leaky_relu(x, 0.2) + F.max_pool2d(x, 2).repeat_interleave(
            2, 2).repeat_interleave(2, 3)

    with KinkPattern() as rec:
        want = step(x)
    relu, leaky, pool = rec.recorded
    assert relu.dtype == torch.bool and torch.equal(relu, x > 0) and torch.equal(leaky, relu)
    assert torch.equal(pool, F.max_pool2d_with_indices(x, 2)[1])
    with KinkPattern(rec.recorded):  # its own pattern: the same step
        assert torch.equal(step(x), want)
    flip = (0, 1, 2, 3)
    relu2, pool2 = relu.clone(), pool.clone()
    relu2[flip] = ~relu2[flip]
    pool2[0, 0, 0, 0] = 1 if pool[0, 0, 0, 0] != 1 else 0  # another pixel of window (0, 0)
    xg = x.clone().requires_grad_(True)
    with KinkPattern([relu2, leaky, pool2]):
        got = step(xg)
    got.sum().backward()
    expect = want.clone()
    expect[flip] += (x[flip] if relu2[flip] else -x[flip])
    won = x[0, 0].flatten()[pool2[0, 0, 0, 0]] - x[0, 0].flatten()[pool[0, 0, 0, 0]]
    expect[0, 0, :2, :2] += won
    torch.testing.assert_close(got.detach(), expect, rtol=0, atol=1e-15)
    # each pool output feeds 4 pixels of the sum; (2, 3) is flat index 11
    assert xg.grad[flip] == (1.0 if relu2[flip] else 0.0) + (1.0 if leaky[flip] else 0.2) + (
        4.0 if pool[0, 1, 1, 1] == 11 else 0.0)
    with pytest.raises(ValueError, match="kinks"):
        with KinkPattern([relu]):
            step(x)


@pytest.mark.parametrize("model_parallel", [1, 2], ids=["image", "video"])
def test_anchor_through_its_own_pattern_is_the_plain_anchor(model_parallel):
    """The float64 anchor taken through a float64 step's own kink pattern
    is today's anchor exactly (every call agrees, so every function runs as
    itself), and flipping one recorded ReLU kink moves it."""
    import torch

    from vad_tpu_torch.parallel.multiprocess_check import anchor_first_step, first_step

    plain, init = anchor_first_step(model_parallel)
    _, _, pattern = first_step(model_parallel, torch.float64)
    replayed, init2 = anchor_first_step(model_parallel, pattern)
    assert all(np.array_equal(plain[n], replayed[n]) for n in plain)
    assert all(np.array_equal(init[n], init2[n]) for n in init)
    flipped = [k.clone() for k in pattern]
    relu = next(i for i, k in enumerate(flipped) if k.dtype == torch.bool and k.any())
    flipped[relu][tuple(torch.nonzero(flipped[relu])[0])] = False
    moved, _ = anchor_first_step(model_parallel, flipped)
    assert any(not np.array_equal(plain[n], moved[n]) for n in plain)


def test_judge_fails_a_rank_gradient_halved():
    """Each run judged by the float64 step through its own kinks: a
    1-process f32 step passes against itself, and a step whose second
    rank's rows count half in the loss (that rank's gradient halved, the
    global BatchNorm coupling kept) fails the gradient bar."""
    import torch

    from vad_tpu_torch.parallel.multiprocess_check import (
        BATCH_SIZE,
        _model_and_data,
        anchor_first_step,
        first_step,
        judge_training,
        zero_gradient_biases,
    )

    skip = set(zero_gradient_biases(_model_and_data(1)[0]))
    weights = np.ones(BATCH_SIZE)
    weights[BATCH_SIZE // 2:] = 0.5
    runs, anchors = {}, {}
    for name, loss_weights in (("control", None), ("halved", weights)):
        grad, init, pattern = first_step(1, None, loss_weights=loss_weights)
        runs[name] = {"grad": grad, "states": [{n: init[n] - 1e-3 * np.sign(g)
                                                for n, g in grad.items()}]}
        anchors[name], _ = anchor_first_step(1, pattern)
    ok = judge_training(runs["control"], runs["control"], anchors["control"], init, skip,
                        got_anchor=anchors["control"])
    assert ok["ok"], ok
    bad = judge_training(runs["halved"], runs["control"], anchors["control"], init, skip,
                         got_anchor=anchors["halved"])
    assert not bad["ok"] and any(f.startswith("gradient of") for f in bad["failed"]), bad


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(module: str, argv: list, results: Path, world: int = 2) -> Path:
    """``python -m module argv`` as ``world`` ranks under torchrun's
    environment (``world`` 1: one plain process); returns rank 0's run
    directory."""
    port = _free_port()
    procs, logs = [], []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
        if world > 1:
            env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        logs.append(results.parent / f"{results.name}_rank{rank}.log")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv, "--results-dir", str(results)], env=env,
            cwd=str(REPO), stdout=open(logs[-1], "w"), stderr=subprocess.STDOUT))
    try:
        rcs = [p.wait(timeout=TIMEOUT) for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{module} ranks did not finish in {TIMEOUT} s: "
                    + logs[0].read_text()[-3000:])
    assert rcs == [0] * world, "\n".join(log.read_text()[-3000:] for log in logs)
    if world > 1:
        assert "Process group: gloo, rank 1 of 2" in logs[1].read_text()
    (run,) = [d for d in results.iterdir() if d.is_dir()]
    return run


def test_image_trainer_entry_tp_matches_dp(synthetic_image_root, tmp_path):
    """``python -m vad_tpu_torch.train`` as 2 ranks: ``--model-parallel 2``
    (one data row duplicated over both ranks: the image model has no gate
    weights to split) against ``--model-parallel 1`` (dp=2)."""
    hist = {}
    for mp in (1, 2):
        run = run_ranks("vad_tpu_torch.train", [
            "--device", "cpu", "--category", "synthetic", "--data-dir", synthetic_image_root,
            "--image-size", "32", "--latent-dim", "32", "--epochs", "2", "--batch-size", "8",
            "--num-workers", "2", "--model-parallel", str(mp)], tmp_path / f"mp{mp}")
        hist[mp] = load_checkpoint(run / "final_model.ckpt")["history"]
    for key in ("train_loss", "val_loss", "anomaly_err"):
        np.testing.assert_allclose(hist[1][key], hist[2][key], rtol=3e-3, err_msg=key)


def test_video_trainer_entry_tp_matches_dp(synthetic_video_root, tmp_path):
    """``python -m vad_tpu_torch.train_video`` as 2 ranks for 2 epochs:
    ``--model-parallel 2`` (the gate weights sliced over both ranks)
    against ``--model-parallel 1`` (dp=2): the same separation trajectory
    and best-checkpoint selection; batch 8 pads to 8 on both meshes."""
    out = {}
    for mp in (1, 2):
        run = run_ranks("vad_tpu_torch.train_video", [
            "--device", "cpu", "--category", "S01", "--data-dir", synthetic_video_root,
            "--image-size", "32", "--sequence-length", "4", "--stride", "4",
            "--latent-dim", "16", "--lstm-hidden-dim", "16", "--epochs", "2",
            "--batch-size", "8", "--num-workers", "2", "--model-parallel", str(mp)],
            tmp_path / f"vmp{mp}")
        out[mp] = (load_checkpoint(run / "final_model.ckpt"),
                   load_checkpoint(run / "best_model.ckpt"))
    (f1, c1), (f2, c2) = out[1], out[2]
    h1, h2 = f1["history"], f2["history"]
    np.testing.assert_allclose(h1["train_loss"], h2["train_loss"], rtol=3e-3)
    np.testing.assert_allclose(h1["separation"], h2["separation"], rtol=3e-3)
    assert f1["best_epoch"] == f2["best_epoch"] and c1["epoch"] == c2["epoch"]
    np.testing.assert_allclose(c1["separation"], c2["separation"], rtol=3e-3)
    # the gathered gate kernels land in JAX's layout; Adam's early steps are
    # ~sign updates, so cross-mesh rounding walks tiny weights by O(lr)
    kernel = c2["params"]["convlstm"]["ConvLSTMLayer_0"]["kernel"]
    assert np.asarray(kernel).shape == (3, 3, 32, 64)
    for path, a in _leaves(c1["params"]).items():
        np.testing.assert_allclose(a, _leaves(c2["params"])[path], rtol=5e-3, atol=1e-3,
                                   err_msg=path)
    # Adam's moments too: full size in the checkpoint, whichever mesh wrote it
    for state in (c1["torch_opt_state"]["state"], c2["torch_opt_state"]["state"]):
        assert {tuple(np.shape(s["exp_avg"])) for s in state.values()} >= {(64,), (64, 16, 3, 3)}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_tensor_parallel_resume_of_a_jax_checkpoint(synthetic_video_root, tmp_path):
    """``train_video --resume`` of a JAX-written checkpoint with optax's
    state (``tests/test_torch_resume_opt_state.py``'s) as 2 ranks under
    ``--model-parallel 2``, against the same resume in one process: each
    rank loads the full tree and slices its part of the gate weights and
    of Adam's moments, so the next epoch's loss and the final checkpoint
    (weights, moments, step count, gathered back to full size) are equal."""
    from tests.test_torch_resume_opt_state import B, LR, SIZE, STEPS, T, jax_run

    out = {}
    for world in (1, 2):
        run = tmp_path / f"w{world}" / "video_S01_jax"
        run.mkdir(parents=True)
        jax_run("video", run / "best_model.ckpt", epoch=1)
        run_ranks("vad_tpu_torch.train_video", [
            "--device", "cpu", "--category", "S01", "--data-dir", synthetic_video_root,
            "--image-size", str(SIZE), "--sequence-length", str(T), "--stride", "8",
            "--batch-size", str(B), "--num-workers", "0", "--latent-dim", "16",
            "--lstm-hidden-dim", "16", "--lstm-layers", "1", "--epochs", "2", "--lr", str(LR),
            "--resume", str(run / "best_model.ckpt"),
            *(["--model-parallel", "2"] if world == 2 else [])], run.parent, world)
        out[world] = load_checkpoint(run / "final_model.ckpt")
    one, two = out[1], out[2]
    assert one["history"]["train_loss"] == pytest.approx(two["history"]["train_loss"],
                                                          rel=1e-5)
    for path, a in _leaves(one["params"]).items():
        np.testing.assert_allclose(_leaves(two["params"])[path], a, rtol=1e-4, atol=1e-5,
                                   err_msg=path)
    s1, s2 = one["torch_opt_state"]["state"], two["torch_opt_state"]["state"]
    assert s1.keys() == s2.keys()
    for i in s1:
        assert float(s1[i]["step"]) == float(s2[i]["step"]) > STEPS
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(np.asarray(s2[i][key]), np.asarray(s1[i][key]),
                                       rtol=1e-4, atol=1e-9, err_msg=f"{i} {key}")


def test_check_runs_on_the_card_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
    """``launch`` and the CLI default to ``cuda``, as every entry point of
    the port: without a card they raise before a process is spawned."""
    import inspect

    from vad_tpu_torch.parallel import multiprocess_check

    assert inspect.signature(launch).parameters["device"].default == "cuda"
    spawned = []
    monkeypatch.setattr(multiprocess_check.subprocess, "Popen",
                        lambda *a, **kw: spawned.append(a))
    monkeypatch.setattr(multiprocess_check.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        multiprocess_check.main(["--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        launch(out_dir=str(tmp_path))
    assert spawned == [] and not any(tmp_path.iterdir())
