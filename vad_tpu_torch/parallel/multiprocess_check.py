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
does.  Its step is piecewise linear: every BatchNorm output feeds a
(leaky) ReLU or a 2x2 max-pool, and f32 rounding may put an element on
the other side of a kink in one run and not in another (on an H100 one
BatchNorm output at 16 rows; ``python -m vad_tpu_torch.tools.probe_kinks``),
which moves every gradient upstream of it by about 1%.  So each f32 run
records every step's pattern (``KinkPattern``: the sign of every ReLU and
LeakyReLU input, every 2x2 max-pool's winner), the control takes its
steps through the 2-rank run's kinks (``launch``), and the launcher takes
the float64 step once with the 2-rank run's pattern and once with the
control's (``anchor_first_step``): each run is judged by its distance from
its own anchor.
``--model-parallel 2`` trains the video model with the model group
spanning both processes (column j of the one data row is process j), so
the gate weights are sliced across the process boundary and gathered over
it every step; the worker asserts that the other rank holds another slice.

Usage (launcher; spawns the workers and the control, compares):
    python -m vad_tpu_torch.parallel.multiprocess_check [--processes 2]
        [--steps 2] [--model-parallel 1|2] [--device cuda|cpu]

It runs on the card (``--device cuda``, the default, as every entry point
of the port) unless ``--device cpu`` asks for the CPU.
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
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from vad_tpu_torch.core.device import resolve_device

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

    forced = []
    with tf32_off(device.type == "cuda"):
        it = iter(loader)
        for step in range(args.steps):
            batch, n_real = next(it)
            # the control replays the distributed run's kinks (``launch``)
            replay = (torch.load(Path(args.replay) / f"replay_step{step}.pt")
                      if args.replay else None)
            with KinkPattern(replay) as kinks:
                losses.append(float(train_step(model, optimizer, batch["image"], n_real)))
            forced.append([kinks.forced, kinks.elements])
            torch.save(kinks.recorded if replay is None else replay,
                       out / f"pattern{args.process_id}_step{step}.pt")
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
        "kinks_forced": forced,
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


class KinkPattern(TorchFunctionMode):
    """The kinks of a step's piecewise-linear activations, recorded or
    replayed while the mode is active.

    Recording (``replay`` None) leaves the computation as it is and keeps,
    in call order, the sign of every ``F.relu`` and ``F.leaky_relu`` input
    (``x > 0``) and the winner of every ``F.max_pool2d`` window (its flat
    index in the input plane, ``max_pool2d_with_indices``'), on the CPU, in
    ``recorded``.  Replaying computes each of them through the recorded
    pattern instead: ``where(mask, x, 0)``, ``where(mask, x, slope * x)``
    and a gather of the winners, so a float64 step follows the kinks of an
    f32 run.  A call whose kinks all agree with the pattern runs the
    function itself (the same function, the same autograd op), so a step
    replaying its own pattern is that step bit for bit; ``forced`` counts
    the kink elements that differ, of ``elements`` replayed."""

    def __init__(self, replay=None) -> None:
        super().__init__()
        self.replay = None if replay is None else list(replay)
        self.recorded = []
        self.forced = self.elements = 0
        self._next = 0

    def __exit__(self, *exc) -> None:
        super().__exit__(*exc)
        if exc[0] is None and self.replay is not None and self._next != len(self.replay):
            raise ValueError(f"the step used {self._next} of the pattern's "
                             f"{len(self.replay)} kinks")

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in (F.relu, F.leaky_relu, F.max_pool2d):
            return func(*args, **kwargs)
        x = args[0]
        pool = func is F.max_pool2d
        with torch.no_grad():
            own = F.max_pool2d_with_indices(*args, **kwargs)[1] if pool else x > 0
        if self.replay is None:
            self.recorded.append(own.cpu())
            return func(*args, **kwargs)
        if self._next >= len(self.replay):
            raise ValueError(f"the step has more kinks than the pattern's {len(self.replay)}")
        kink = self.replay[self._next].to(x.device)
        self._next += 1
        if own.shape != kink.shape:
            raise ValueError(f"kink {self._next - 1}: pattern {tuple(kink.shape)}, "
                             f"step {tuple(own.shape)}")
        self.elements += kink.numel()
        if torch.equal(own, kink):
            return func(*args, **kwargs)
        self.forced += int((own != kink).sum())
        if pool:  # in the input's memory format, as max_pool2d's output
            out = x.flatten(2).gather(2, kink.flatten(2)).view(kink.shape)
            if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(
                    memory_format=torch.channels_last):
                out = out.contiguous(memory_format=torch.channels_last)
            return out
        if func is F.relu:
            return torch.where(kink, x, torch.zeros_like(x))
        slope = args[1] if len(args) > 1 else kwargs.get("negative_slope", 0.01)
        return torch.where(kink, x, x * slope)


def join_patterns(patterns: list) -> list:
    """One global batch's pattern from its row blocks' (the ranks of one
    model column, in data order): each kink's rows concatenated."""
    return [torch.cat(parts) for parts in zip(*patterns)]


def first_step(model_parallel: int, dtype=None, pattern=None, loss_weights=None) -> tuple:
    """The 1-process program's first step on the CPU (the first global
    batch, the initial weights), in ``dtype`` (``None``: f32), through
    ``pattern``'s kinks when given: (its effective gradient, the gradient
    plus Adam's coupled weight decay, by parameter name, float64 numpy;
    the initial weights; the kink pattern the step took).
    ``loss_weights``: a weight per row of the per-sample loss (a rank's
    share of the gradient scaled, for tests)."""

    from vad_tpu_torch.data.loader import DistributedLoader
    from vad_tpu_torch.ops.losses import mse_per_sample
    from vad_tpu_torch.train.steps import make_train_step

    model, dataset = _model_and_data(model_parallel)
    weights = {n: p.detach().double().numpy().copy() for n, p in model.named_parameters()}
    loader = DistributedLoader(dataset, BATCH_SIZE, shuffle=True, seed=SEED, num_workers=0,
                               device="cpu")
    batch, n_real = next(iter(loader))
    loss = mse_per_sample
    if loss_weights is not None:
        scale = torch.as_tensor(loss_weights)
        loss = lambda pred, x: mse_per_sample(pred, x) * scale.to(pred.dtype)  # noqa: E731
    opt = torch.optim.SGD(model.parameters(), lr=0.0)  # keeps the weights, leaves .grad
    with KinkPattern(pattern) as kinks:
        make_train_step(loss, dtype)(model, opt, batch["image"], n_real)
    grad = {n: p.grad.double().numpy() + WEIGHT_DECAY * weights[n]
            for n, p in model.named_parameters()}
    return grad, weights, kinks.recorded if pattern is None else pattern


def anchor_first_step(model_parallel: int, pattern=None) -> tuple:
    """(the effective gradient of the first step, by parameter name; the
    initial weights) of the 1-process program taken in float64 on the CPU:
    the first global batch, the same weights, through ``pattern``'s kinks
    (a run's ``KinkPattern``; ``None``: float64's own)."""
    grad, weights, _ = first_step(model_parallel, torch.float64, pattern)
    return grad, weights


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
# The share of its kink elements the control may take otherwise than its
# own f32 rounding would (``launch``): a flipped kink is an element at
# rounding noise across a ReLU's zero or a near tie of a max-pool; a wrong
# distributed step flips far more.
FORCED_KINKS = 1e-4


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def judge_training(got: dict, control: dict, anchor: dict, init: dict, skip: set,
                   f32: bool = True, got_anchor: dict | None = None) -> dict:
    """A distributed run's training against the 1-process control's on the
    same global batches.

    ``got`` and ``control``: ``{"grad": the first step's effective gradient
    (the gradient plus Adam's coupled weight decay) by parameter name,
    "states": [the state dict after each step judged, the first step's
    first]}`` (numpy or CPU tensors); ``anchor``: the same effective
    gradient of the control's program in float64, through the control's
    kinks; ``got_anchor``: the same through the run's own kinks
    (``KinkPattern``; ``None``: ``anchor``); ``init``: the weights
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
      further from its own anchor (rel L2) than twice the control is from
      the control's, + 1e-5.
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

    got_anchor = anchor if got_anchor is None else got_anchor
    by_anchor, failed, waived, updates, at_noise = {}, [], 0, {}, {}
    for name, exact in anchor.items():
        if name in skip:
            continue
        g, ref, exact = arr(got["grad"][name]), arr(control["grad"][name]), arr(exact)
        own = arr(got_anchor[name])
        at_noise[name] = np.abs(exact) <= (2 * np.abs(ref - exact).max()
                                           + GRADIENT_NOISE * np.abs(exact).max())
        if f32 and not np.allclose(g, ref, rtol=F32_BAR["rtol"],
                                   atol=F32_BAR["atol"] * np.abs(ref).max()):
            rec = {"rel_l2_to_control": _rel_l2(g, ref), "rel_l2_to_f64": _rel_l2(g, own),
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
           timeout: float = 600.0, model_parallel: int = 1, device: str = "cuda") -> dict:
    """Spawn the multi-process run and a 1-process control; check that
    every rank agrees, that the losses match the control's and that the
    checkpoints match the control's (``judge_training``).

    The control takes every step through the kinks the distributed run
    took (its ranks' ``KinkPattern`` joined in row order), so the two runs
    differ only in how their sums are taken, which is what the check
    tests: a kink that f32 rounding puts on one side in one run and on the
    other in the other decides the sign of Adam's first step for every
    weight whose exact gradient it moves across zero, and the runs part
    from there.  At most ``FORCED_KINKS`` of the control's kink elements
    may differ from its own.  Each run's first-step gradient is judged
    against the float64 step through its own kinks.
    Prints the record as one JSON line, then raises ``AssertionError``
    naming what failed, or returns the record.  ``device`` is every rank's
    and the control's: ``"cuda"`` (the card; raises when there is none) or
    ``"cpu"``."""
    resolve_device(device)
    out = Path(out_dir or tempfile.mkdtemp(prefix="vad_torch_mp_"))

    def cmd(process_id: int, num_processes: int, sub: Path) -> list:
        replay = ["--replay", str(sub)] if num_processes == 1 else []
        return [sys.executable, "-m", "vad_tpu_torch.parallel.multiprocess_check", "--worker",
                "--process-id", str(process_id), "--num-processes", str(num_processes),
                "--init-method", f"file://{sub / 'store'}", "--model-parallel",
                str(model_parallel), "--steps", str(steps), "--device", device,
                "--out", str(sub), *replay]

    def joined(sub: Path, n: int, step: int) -> list:
        """A run's kink pattern of one step over the global batch: its
        model column's ranks (0, mp, 2 mp, ...: data order)."""
        return join_patterns([torch.load(sub / f"pattern{p}_step{step}.pt")
                              for p in range(0, n, model_parallel if n > 1 else 1)])

    runs = {}
    for name, n in (("multiproc", processes), ("singleproc", 1)):
        sub = out / name
        (sub / "ckpt").mkdir(parents=True, exist_ok=True)
        if n == 1:
            for step in range(steps):
                torch.save(joined(out / "multiproc", processes, step),
                           sub / f"replay_step{step}.pt")
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
    forced, elements = (sum(f[k] for f in control["kinks_forced"]) for k in (0, 1))
    if forced > FORCED_KINKS * elements:
        failed.append(f"the control forced {forced} of {elements} kinks")
    # each run's float64 anchor follows the kinks its own first step took
    model, _ = _model_and_data(model_parallel)
    anchors = {}
    for name, n in (("multiproc", processes), ("singleproc", 1)):
        anchors[name], init = anchor_first_step(model_parallel, joined(out / name, n, 0))
    loaded = {name: _load_run(out / name, model_parallel) for name in anchors}
    skip = set(zero_gradient_biases(model))
    checkpoint = judge_training(loaded["multiproc"], loaded["singleproc"],
                                anchors["singleproc"], init, skip,
                                got_anchor=anchors["multiproc"])
    failed += [f"checkpoint: {f}" for f in checkpoint["failed"]]
    # each run's first-step gradients against its own float64 anchor
    to_anchor = {}
    for name, anchor in anchors.items():
        dist = [_rel_l2(loaded[name]["grad"][k], anchor[k]) for k in anchor if k not in skip]
        to_anchor[name] = {"median": float(np.median(dist)), "max": float(np.max(dist))}
    result = {
        "processes": processes,
        "model_parallel": model_parallel,
        "device": device,
        "backend": records[0]["backend"],
        "steps": steps,
        "multiproc_losses": records[0]["losses"],
        "singleproc_losses": control["losses"],
        "launches": [r["launches"] for r in records],
        "control_kinks_forced": {"forced": forced, "elements": elements},
        "grad_rel_l2_to_own_anchor": to_anchor,
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
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--replay", default=None,
                    help="(worker) take each step through the kink patterns in this directory")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.worker:
        run_worker(args)
    else:
        launch(args.processes, args.steps, args.out, args.timeout,
               model_parallel=args.model_parallel, device=args.device)


if __name__ == "__main__":
    main()
