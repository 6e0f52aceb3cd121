"""Real multi-PROCESS execution check of the port's distributed path (the
JAX package's ``vad_tpu/parallel/multiprocess_check.py``).

It spawns N Python processes joined by a ``torch.distributed`` process
group (a ``FileStore`` in the run's own directory, so parallel runs never
collide; gloo on the CPU or on one shared card, NCCL when each rank has a
card) and drives the REAL training stack over the resulting mesh:

- every process builds the same deterministic dataset and a
  ``DistributedLoader``, so each rank decodes ONLY its rows of every
  global batch;
- ``make_train_step`` (the trainers' step: masked loss over the global
  ``n_real``, BatchNorm over the data group, the f32 gradient all-reduce,
  Adam) runs ``--steps`` steps;
- ``to_host`` of a batch gives every rank the same global batch;
- rank 0 writes a checkpoint (the full weights and Adam moments,
  gathered) behind a barrier after the first step and after the last, and
  every rank reloads the last and holds its own slices against it;
- the launcher asserts that all ranks agree, that their losses match a
  1-process control over the same global batches (the single-device
  program), and that the run's checkpoints (after the first step and after
  the last) match the control's by ``judge_training``, the rule
  ``chip_smoke.py``'s scaling phase applies too.

Without ``--model-parallel`` the check trains the image model, as JAX's
does.  On the CPU that form passes; on an H100 its f32 step is
reproducible only to about 1% across batch splits, because f32 rounding
puts a BatchNorm output on the other side of its ReLU's zero (ROADMAP
Queue 3 (e); ``python -m vad_tpu_torch.tools.probe_kinks``).
``--model-parallel 2`` trains the video model with the model group
spanning both processes (column j of the one data row is process j), so
the gate weights are sliced across the process boundary and gathered over
it every step; the worker asserts that the other rank holds another slice.

Usage (launcher; spawns the workers and the control, compares):
    python -m vad_tpu_torch.parallel.multiprocess_check [--processes 2]
        [--steps 2] [--model-parallel 1|2] [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

IMAGE_SIZE = 16
LATENT_DIM = 32
DATASET_SIZE = 64
BATCH_SIZE = 16
SEED = 0
LEARNING_RATE, WEIGHT_DECAY = 1e-3, 1e-5


class DeterministicImages:
    """Seeded in-memory uint8 images ``[H, W, 3]``, identical in every
    process, so the ranks' rows are rows of the same global sample set."""

    def __init__(self, n: int = DATASET_SIZE, size: int = IMAGE_SIZE) -> None:
        rng = np.random.default_rng(0)
        self.images = rng.integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> dict:
        return {"image": self.images[i]}


class DeterministicVideos(DeterministicImages):
    """The same, as clips ``[T, H, W, 3]``."""

    def __init__(self, n: int = DATASET_SIZE, size: int = IMAGE_SIZE, t: int = 2) -> None:
        rng = np.random.default_rng(0)
        self.images = rng.integers(0, 256, size=(n, t, size, size, 3), dtype=np.uint8)


def zero_gradient_biases(model) -> list:
    """The conv biases that feed a train-mode BatchNorm, in either model
    family: the norm subtracts the batch mean, so their exact gradient is
    zero, a computed one is rounding noise and Adam turns it into steps of
    the learning rate's size (left out of parameter comparisons)."""
    if model.norm != "batch":
        return []
    if hasattr(model.encoder, "convs"):  # the video model
        return ([f"encoder.convs.{i}.bias" for i in range(len(model.encoder.convs))]
                + [f"decoder.deconvs.{i}.bias" for i in range(len(model.decoder.norms))])
    return ([f"encoder.blocks.{i}.{c}.bias" for i in range(len(model.encoder.blocks))
             for c in ("conv1", "conv2")]
            + [f"decoder.blocks.{i}.{c}.bias" for i in range(len(model.decoder.blocks))
               for c in ("deconv", "conv")] + ["decoder.deconv.bias"])


def _model_and_data(model_parallel: int):
    """The image model on images without tensor parallelism (it has no
    gate weights to slice), else the video model on clips."""
    from vad_tpu_torch.models.autoencoder import ConvAutoencoder
    from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_training_weights

    if model_parallel > 1:
        model = VideoAutoencoder(in_channels=3, latent_dim=8, lstm_hidden_dim=8,
                                 lstm_layers=1, device="cpu")
        return init_training_weights(model, SEED), DeterministicVideos()
    model = ConvAutoencoder(latent_dim=LATENT_DIM, device="cpu")
    return init_training_weights(model, SEED), DeterministicImages()


def run_worker(args) -> None:
    """One rank of the distributed program, or the 1-process control
    (``--num-processes 1``: no process group)."""
    import torch

    from vad_tpu_torch.data.loader import DistributedLoader
    from vad_tpu_torch.ops import convlstm
    from vad_tpu_torch.ops.losses import mse_per_sample
    from vad_tpu_torch.parallel.multihost import to_host
    from vad_tpu_torch.parallel.sharding import (
        MODEL_AXIS,
        _gather_full,
        distribute,
        get_mesh,
        init_distributed,
    )
    from vad_tpu_torch.train.state import make_optimizer
    from vad_tpu_torch.train.steps import make_train_step
    from vad_tpu_torch.train.video_trainer import save_on_main
    from vad_tpu_torch.utils.checkpoint import load_checkpoint
    from vad_tpu_torch.utils.precision import tf32_off
    from vad_tpu_torch.utils.weights import load_flax_variables, state_dict_to_flax

    out = Path(args.out)
    device = torch.device(args.device)
    mp = max(1, args.model_parallel)
    if args.num_processes > 1:
        device = init_distributed(args.device, init_method=args.init_method,
                                  rank=args.process_id, world_size=args.num_processes)
        if mp > 1 and mp != args.num_processes:
            raise ValueError("the cross-process tp check needs model_parallel == processes")
        mesh = get_mesh(model_parallel=mp)
    else:
        mesh = get_mesh([device])
    model, dataset = _model_and_data(mp)
    model = model.to(device)
    optimizer = make_optimizer(model.parameters(), LEARNING_RATE, WEIGHT_DECAY)
    shardings = distribute(model, mesh, optimizer)
    if mesh.shape[MODEL_AXIS] > 1:
        # the check is real: each gate parameter holds 1/mp of its channels,
        # and the other rank holds other values of the gate kernels
        params = dict(model.named_parameters())
        assert shardings, "no parameter sliced over 'model'"
        differ = []
        for name, dim in shardings.items():
            full = _gather_full(params[name].data, dim, mesh)
            n = params[name].shape[dim]
            assert full.shape[dim] == n * mp, name
            other = (mesh.model_index + 1) % mp
            differ.append(not torch.equal(full.narrow(dim, other * n, n), params[name].data))
        assert any(differ), "no gate slice on the other rank differs from this rank's"

    train_step = make_train_step(mse_per_sample, mesh=mesh)
    loader = DistributedLoader(dataset, BATCH_SIZE, mesh=mesh, shuffle=True, seed=SEED,
                               num_workers=0, device=device)
    for fn in (convlstm.convlstm_train_forward, convlstm.convlstm_backward):
        fn.launches = 0
    losses = []

    def save(path: Path) -> None:
        save_on_main(path, lambda: {**state_dict_to_flax(model), "losses": losses,
                                    "torch_opt_state": optimizer.state_dict()},
                     model, optimizer, mesh)

    with tf32_off(device.type == "cuda"):
        it = iter(loader)
        for step in range(args.steps):
            batch, n_real = next(it)
            losses.append(float(train_step(model, optimizer, batch["image"], n_real)))
            if step == 0:
                save(out / "ckpt" / "step1_model.ckpt")
    launches = {"convlstm_train_forward": convlstm.convlstm_train_forward.launches,
                "convlstm_backward": convlstm.convlstm_backward.launches}

    # every rank sees the identical global batch
    batch, _ = next(iter(loader))
    global_batch = to_host(batch["image"], mesh)
    assert global_batch.shape[0] == loader.pad_to

    ckpt = out / "ckpt" / "proc0_model.ckpt"
    save(ckpt)
    # every rank (0 included) reloads the full tree and slices its part
    restored = load_checkpoint(ckpt)
    assert restored["losses"] == losses
    fresh, _ = _model_and_data(mp)
    load_flax_variables(fresh, {"params": restored["params"],
                                "batch_stats": restored.get("batch_stats") or {}})
    fresh = fresh.to(device)
    distribute(fresh, mesh)
    live = model.state_dict()
    for name, value in fresh.state_dict().items():
        if not name.endswith("num_batches_tracked"):  # torch's own counter, not in the tree
            assert torch.equal(value, live[name]), f"reloaded {name} differs on rank {mesh.rank}"

    record = {
        "process_id": args.process_id,
        "process_count": mesh.process_count,
        "mesh": mesh.shape,
        "backend": mesh.backend,
        "device": str(device),
        "losses": losses,
        "launches": launches,
        "sliced": sorted(shardings),
        "global_batch_sha": int(np.asarray(global_batch, dtype=np.uint64).sum()),
    }
    (out / f"proc{args.process_id}.json").write_text(json.dumps(record))
    print(f"[proc {args.process_id}] {record}", flush=True)
    if args.num_processes > 1:
        import torch.distributed as dist

        dist.destroy_process_group()


def _worker_env() -> dict:
    env = dict(os.environ)
    repo = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    env.setdefault("OMP_NUM_THREADS", "2")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)  # the workers join the check's own store
    return env


def _wait_all(procs, logs, timeout: float) -> list:
    """Exit codes of ``procs``; a worker still running at ``timeout`` (a
    hung rendezvous) is killed with the others and the check fails."""
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=timeout))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise RuntimeError(f"workers did not finish within {timeout} s:\n" + "\n".join(
            Path(log).read_text()[-2000:] for log in logs))
    return rcs


def _load_run(sub: Path, model_parallel: int) -> dict:
    """A run's training from its checkpoints, as ``judge_training`` reads
    it: the first step's effective gradient (torch's Adam adds the coupled
    weight decay to the gradient before its moments, so the first moment
    is 0.1 * (g + wd * w)) and the state dict after the first step and
    after the last, numpy in the port's naming."""
    from vad_tpu_torch.utils.checkpoint import load_checkpoint
    from vad_tpu_torch.utils.weights import load_flax_variables

    out = {"states": []}
    for name in ("step1_model.ckpt", "proc0_model.ckpt"):
        ckpt = load_checkpoint(sub / "ckpt" / name)
        model, _ = _model_and_data(model_parallel)
        load_flax_variables(model, {"params": ckpt["params"],
                                    "batch_stats": ckpt.get("batch_stats") or {}})
        out["states"].append({n: t.numpy() for n, t in model.state_dict().items()})
        if "grad" not in out:
            names = [n for n, _ in model.named_parameters()]
            out["grad"] = {names[int(i)]: np.asarray(st["exp_avg"], np.float64) / 0.1
                           for i, st in ckpt["torch_opt_state"]["state"].items()}
    return out


def anchor_first_step(model_parallel: int) -> tuple:
    """(the effective gradient of the first step, by parameter name; the
    initial weights) of the 1-process program taken in float64 on the CPU:
    the first global batch, the same weights."""
    import torch

    from vad_tpu_torch.data.loader import DistributedLoader
    from vad_tpu_torch.ops.losses import mse_per_sample
    from vad_tpu_torch.train.steps import make_train_step

    model, dataset = _model_and_data(model_parallel)
    weights = {n: p.detach().double().numpy().copy() for n, p in model.named_parameters()}
    loader = DistributedLoader(dataset, BATCH_SIZE, shuffle=True, seed=SEED, num_workers=0,
                               device="cpu")
    batch, n_real = next(iter(loader))
    opt = torch.optim.SGD(model.parameters(), lr=0.0)  # keeps the weights, leaves .grad
    make_train_step(mse_per_sample, torch.float64)(model, opt, batch["image"], n_real)
    return {n: p.grad.double().numpy() + WEIGHT_DECAY * weights[n]
            for n, p in model.named_parameters()}, weights


# judge_training's bars: the repo's f32 and bf16 parity bars; the rel L2 a
# bf16 run's last state may lie from the control's; the rel L2 each weight's
# update may lie from the control's update where the first step's sign is
# not at noise (a skipped update reads 1, a halved one 0.5); the share of a
# tensor's largest exact gradient under which rounding may pick the sign
# of Adam's first step.
F32_BAR = dict(rtol=1e-4, atol=1e-5)
BF16_BAR = dict(rtol=0.05, atol=0.02)
BF16_REL_L2 = 0.05
UPDATE_REL_L2 = 0.25
GRADIENT_NOISE = 1e-4


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def judge_training(got: dict, control: dict, anchor: dict, init: dict, skip: set,
                   f32: bool = True) -> dict:
    """A distributed run's training against the 1-process control's on the
    same global batches.

    ``got`` and ``control``: ``{"grad": the first step's effective gradient
    (the gradient plus Adam's coupled weight decay) by parameter name,
    "states": [the state dict after each step judged, the first step's
    first]}`` (numpy or CPU tensors); ``anchor``: the same effective
    gradient of the control's program in float64; ``init``: the weights
    before the first step; ``skip``: ``zero_gradient_biases``, left out
    with the BatchNorm running means they shift.

    Adam's first step is about lr * sign(g), so an element whose exact
    effective gradient lies within twice the control's largest error on
    its tensor (+ ``GRADIENT_NOISE`` of the largest exact entry) of zero
    may step either way in any run of that precision: such elements are
    "at noise".  The mask reads the control's error only, so a run's own
    wrong gradient cannot excuse its weight.

    - f32, the first step's effective gradient of each parameter: allclose
      to the control's at ``F32_BAR`` (atol of its largest entry), or no
      further from the anchor (rel L2) than twice the control is, + 1e-5.
      A backend may sum in another order or take another convolution
      algorithm at another batch size, so the run may differ from the
      control by the size of their f32 errors, but it may not be less
      exact than a plain step.
    - f32, each weight after the first step: at ``F32_BAR`` against the
      control's, or at noise.
    - Each weight's update after every step judged (w - init) over the
      elements not at noise: within ``UPDATE_REL_L2`` of the control's
      update, so an update skipped or scaled on one rank cannot pass.
    - Every other entry (the running variances): f32 at ``F32_BAR`` after
      every step; in bf16 the last state whole at ``BF16_BAR`` with rel L2
      <= ``BF16_REL_L2``.

    Returns the record: what was judged by the anchor (with the run's and
    the control's distances from it), the updates' worst rel L2, the
    elements at noise whose first-step weight missed the f32 bar, what
    failed and ``ok``."""
    def arr(x):
        return np.asarray(x.numpy() if hasattr(x, "numpy") else x, np.float64)

    by_anchor, failed, waived, updates, at_noise = {}, [], 0, {}, {}
    for name, exact in anchor.items():
        if name in skip:
            continue
        g, ref, exact = arr(got["grad"][name]), arr(control["grad"][name]), arr(exact)
        at_noise[name] = np.abs(exact) <= (2 * np.abs(ref - exact).max()
                                           + GRADIENT_NOISE * np.abs(exact).max())
        if f32 and not np.allclose(g, ref, rtol=F32_BAR["rtol"],
                                   atol=F32_BAR["atol"] * np.abs(ref).max()):
            rec = {"rel_l2_to_control": _rel_l2(g, ref), "rel_l2_to_f64": _rel_l2(g, exact),
                   "control_rel_l2_to_f64": _rel_l2(ref, exact)}
            by_anchor[name] = rec
            if rec["rel_l2_to_f64"] > 2 * rec["control_rel_l2_to_f64"] + 1e-5:
                failed.append(f"gradient of {name}")
    last = len(control["states"]) - 1
    for k, (state, ref_state) in enumerate(zip(got["states"], control["states"])):
        for name, ref in ref_state.items():
            if name in skip or name.endswith(("running_mean", "num_batches_tracked")):
                continue
            val, ref = arr(state[name]), arr(ref)
            if name in init:
                w0, judged = arr(init[name]), ~at_noise[name]
                if judged.any():
                    apart = _rel_l2((val - w0)[judged], (ref - w0)[judged])
                    updates[name] = max(updates.get(name, 0.0), apart)
                    if apart > UPDATE_REL_L2:
                        failed.append(f"update {k + 1} of {name}")
            if not f32:
                if k == last and not (np.allclose(val, ref, **BF16_BAR)
                                      and _rel_l2(val, ref) <= BF16_REL_L2):
                    failed.append(f"{name} after step {k + 1}")
                continue
            if name in init and k > 0:  # later weights: their updates, above
                continue
            ok = np.isclose(val, ref, **F32_BAR)
            if name in init:
                waived += int(np.sum(~ok & at_noise[name]))
                ok |= at_noise[name]
            if not ok.all():
                failed.append(f"{name} after step {k + 1}")
    worst = max(updates.items(), key=lambda kv: kv[1]) if updates else (None, 0.0)
    return {"compared": len(control["states"][0]), "grads_judged_by_anchor": by_anchor,
            "worst_update_rel_l2": {"name": worst[0], "rel_l2": worst[1]},
            "elements_at_noise": int(sum(m.sum() for m in at_noise.values())),
            "elements_waived": waived, "skipped": sorted(skip), "failed": failed,
            "ok": not failed}


def launch(processes: int = 2, steps: int = 2, out_dir: str | None = None,
           timeout: float = 600.0, model_parallel: int = 1, device: str = "cpu") -> dict:
    """Spawn the multi-process run and a 1-process control; check that
    every rank agrees, that the losses match the control's and that the
    checkpoints match the control's (``judge_training``).
    Prints the record as one JSON line, then raises ``AssertionError``
    naming what failed, or returns the record."""
    out = Path(out_dir or tempfile.mkdtemp(prefix="vad_torch_mp_"))

    def cmd(process_id: int, num_processes: int, sub: Path) -> list:
        return [sys.executable, "-m", "vad_tpu_torch.parallel.multiprocess_check", "--worker",
                "--process-id", str(process_id), "--num-processes", str(num_processes),
                "--init-method", f"file://{sub / 'store'}", "--model-parallel",
                str(model_parallel), "--steps", str(steps), "--device", device,
                "--out", str(sub)]

    runs = {}
    for name, n in (("multiproc", processes), ("singleproc", 1)):
        sub = out / name
        (sub / "ckpt").mkdir(parents=True, exist_ok=True)
        logs = [sub / f"proc{p}.log" for p in range(n)]
        procs = [subprocess.Popen(cmd(p, n, sub), env=_worker_env(), stdout=open(log, "w"),
                                  stderr=subprocess.STDOUT) for p, log in enumerate(logs)]
        rcs = _wait_all(procs, logs, timeout)
        if any(rcs):
            raise RuntimeError(f"{name} exit codes {rcs}:\n" + "\n".join(
                log.read_text()[-3000:] for log in logs))
        runs[name] = [json.loads((sub / f"proc{p}.json").read_text()) for p in range(n)]

    records, control = runs["multiproc"], runs["singleproc"][0]
    failed = []
    for r in records:
        # the loss is a global value: identical on every rank
        if r["process_count"] != processes or r["losses"] != records[0]["losses"] \
                or r["global_batch_sha"] != records[0]["global_batch_sha"]:
            failed.append(f"rank {r['process_id']} disagrees with rank 0")
        if model_parallel > 1 and (not r["sliced"] or r["mesh"] != {
                "data": processes // model_parallel, "model": model_parallel}):
            failed.append(f"rank {r['process_id']}'s mesh {r['mesh']}, sliced {r['sliced']}")
    # the same program on the same global batches: equal up to the order
    # the cross-process sums take
    if not np.allclose(records[0]["losses"], control["losses"], rtol=1e-5, atol=1e-7):
        failed.append("losses against the control")
    if records[0]["global_batch_sha"] != control["global_batch_sha"]:
        failed.append("the global batch against the control's")
    model, _ = _model_and_data(model_parallel)
    anchor, init = anchor_first_step(model_parallel)
    checkpoint = judge_training(_load_run(out / "multiproc", model_parallel),
                                _load_run(out / "singleproc", model_parallel),
                                anchor, init, set(zero_gradient_biases(model)))
    failed += [f"checkpoint: {f}" for f in checkpoint["failed"]]
    result = {
        "processes": processes,
        "model_parallel": model_parallel,
        "device": device,
        "backend": records[0]["backend"],
        "steps": steps,
        "multiproc_losses": records[0]["losses"],
        "singleproc_losses": control["losses"],
        "launches": [r["launches"] for r in records],
        "checkpoint": checkpoint,
        "failed": failed,
        "ok": not failed,
    }
    print(json.dumps(result), flush=True)
    if failed:
        raise AssertionError(f"multiprocess check failed: {failed}")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--init-method", default=None)
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.worker:
        run_worker(args)
    else:
        launch(args.processes, args.steps, args.out, args.timeout,
               model_parallel=args.model_parallel, device=args.device)


if __name__ == "__main__":
    main()
