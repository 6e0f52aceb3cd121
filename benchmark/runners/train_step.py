"""Video training through the port's ``make_train_step`` (the step that
``train/video_trainer.py`` ``fit`` runs) with Adam from ``make_optimizer``.

Traffic parameters: ``batch`` sequences of the configuration's
``sequence_length`` frames a step, ``precision`` (``f32``: TF32 off, the
trainer's default), the per-sample ``loss``, ``learning_rate`` and
``weight_decay``; uint8 batches from a seeded pool of ``pool_batches``
(every row a distinct clip), pinned and copied to the card before each
step, as ``fit``'s loader hands them.  Each step's loss is read one step
late, as ``fit`` reads it; the last before the clock stops.

Set-up builds one model and optimizer and drives them through the first
``checked_steps`` steps with the window's own call and feed; the window
continues with the same objects.  ``correct`` (``judge``): the reference
follows those steps from the same weights and batches: each step's loss,
the first gradient as Adam received it (its first moment after one step
over 1 - beta1, weight decay included) and the parameters' change over
the checked steps.  In the window it checks the last step and
``window_samples`` steps drawn from the seed (a reservoir over the
window): before each of them the parameters and Adam's moments are
copied, and the reference takes that one step from the copy; its loss
and the parameters' change (the median leaf's gap) are compared.

The control (``side == "control"``) runs the program all the same and
then puts the reference in TF32 in its place, from the same starting
points: the weights for the checked steps, the copies for the window's.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from benchmark import judge, scene
from benchmark.reference import video_ae as ref
from benchmark.weights import make_weights, program_state_dict

# A CPU test run (``benchmark/tests/cases.py``): its traffic and the faults
# that ``plant`` takes.  A sound float32 run at this size is not held to the
# cell's limits: they were set on the card at the cell's size, and at 4 clips
# of 4 frames on the 16-channel model the change of the median leaf swings
# past them (``change_gap`` 2.8e-5 to 6.2e-4 against 3.4e-5 on 5 of 6 seeds).
SMALL = {"batch": 4, "pool_batches": 3}
FAULTS = ("unchanged", "half_batch", "window_unchanged", "window_half_batch")
SOUND_SMALL_RUN_CORRECT = False


def batch_pool(ctx) -> torch.Tensor:
    """uint8 ``[pool, B, T, H, W, 3]``: row r of batch b is the first chunk
    of stream ``b * B + r``."""
    tr, cfg = ctx.traffic, ctx.cfg
    b, t, size = tr["batch"], cfg["sequence_length"], cfg["image_size"]
    pool = scene.stream_pool(ctx.seed, tr["pool_batches"] * b, 1, t, size)[0]
    pool = torch.from_numpy(pool.reshape(tr["pool_batches"], b, t, size, size, 3))
    return pool.pin_memory() if ctx.cuda else pool


def plant(run, fault: str):
    """Break the train step underneath (tests and control runs only);
    ``window_<fault>`` breaks it only once the window has opened, after the
    checked steps."""
    late = fault.startswith("window_")
    kind = fault[len("window_"):] if late else fault
    engaged = (lambda: run.in_window) if late else (lambda: True)
    step, optimizer = run.step, run.optimizer
    if kind == "unchanged":
        real = optimizer.step
        optimizer.step = lambda *a, **k: None if engaged() else real(*a, **k)
        return step
    if kind == "half_batch":
        return lambda model, opt, u8, n_real: step(model, opt, u8,
                                                   run.batch // 2 if engaged() else n_real)
    raise ValueError(f"no fault {fault!r} for a train step")


class CellRun:
    def __init__(self, ctx) -> None:
        from vad_tpu_torch.core.config import VideoAEConfig
        from vad_tpu_torch.models.norms import BatchNorm
        from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
        from vad_tpu_torch.ops.losses import make_per_sample_loss_fn
        from vad_tpu_torch.train.state import make_optimizer
        from vad_tpu_torch.train.steps import make_train_step
        from vad_tpu_torch.utils.precision import tf32_off

        self.ctx, tr = ctx, ctx.traffic
        self.batch = tr["batch"]
        self.frames_per_step = self.batch * ctx.cfg["sequence_length"]
        self.weights = make_weights(ctx.cfg, ctx.seed, ctx.device)
        self.pool = batch_pool(ctx)
        ctx.mark("weights and frames")
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(tf32_off(tr["precision"] == "f32" and ctx.cuda))
        model = VideoAutoencoder.from_config(VideoAEConfig.from_args(ctx.cfg), device=ctx.device)
        model.load_state_dict(program_state_dict(self.weights))
        for m in model.modules():
            if isinstance(m, BatchNorm):
                ctx.tracer.annotate(m, "batchnorm")
        optimizer = make_optimizer(model.parameters(), tr["learning_rate"],
                                   weight_decay=tr["weight_decay"])
        step = make_train_step(make_per_sample_loss_fn(tr["loss"]),
                               torch.bfloat16 if tr["precision"] == "bf16" else None)
        self.model, self.optimizer, self.step = model, optimizer, step
        self.in_window = False
        if ctx.fault:
            self.step = plant(self, ctx.fault)
        self.names = [n for n, _ in model.named_parameters()]
        self.params = list(model.parameters())
        self.steps = 0
        ctx.mark("program")
        # the checked steps: the window's own call and feed, before the window
        beta1 = optimizer.param_groups[0]["betas"][0]
        losses = []
        for k in range(tr["checked_steps"]):
            losses.append(self._step())
            if k == 0:
                self.first_grad = {n: m / (1 - beta1)
                                   for n, m in zip(self.names, self._moments("exp_avg"))}
        self.checked = {n: p.detach().clone() for n, p in zip(self.names, self.params)}
        self.losses = [float(x) for x in losses]
        # before each window step the state is copied here, so that the last is held
        self._held = [t.clone() for t in self._live()]
        self._held_taken = self._taken()
        self.sampler = np.random.default_rng(np.random.SeedSequence([int(ctx.seed), 3]))
        self.samples = {}  # reservoir place -> (step, state before, loss, parameters after)
        ctx.mark("checked steps")

    def _moments(self, key: str) -> list:
        """Adam's ``key`` moment of every parameter (zero where Adam holds none)."""
        state = self.optimizer.state
        return [state[p][key].detach() if key in state[p] else torch.zeros_like(p)
                for p in self.params]

    def _taken(self) -> int:
        """The steps Adam has taken (its bias correction's count)."""
        return int(self.optimizer.state[self.params[0]].get("step", 0))

    def _live(self) -> list:
        return [p.detach() for p in self.params] + self._moments("exp_avg") + \
            self._moments("exp_avg_sq")

    def _start(self, held: list, taken: int) -> tuple:
        """A held copy as the reference's starting point, by name."""
        n = len(self.names)
        return tuple(dict(zip(self.names, held[i * n:(i + 1) * n])) for i in range(3)) + (taken,)

    def _step(self) -> torch.Tensor:
        u8 = self.pool[self.steps % len(self.pool)]
        with self.ctx.tracer.span("h2d"):
            u8 = u8.to(self.ctx.device, non_blocking=True)
        with self.ctx.tracer.span("step"):
            loss = self.step(self.model, self.optimizer, u8, self.batch)
        self.steps += 1
        return loss

    def _window_step(self, i: int) -> torch.Tensor:
        """One window step, its state before it held (``i``: its place in the window)."""
        keep = self.ctx.traffic["window_samples"]
        pos = i if i < keep else int(self.sampler.integers(0, i + 1))
        pos = pos if pos < keep else None
        torch._foreach_copy_(self._held, self._live())  # one copy on the card
        self._held_taken = self._taken()
        before = [t.clone() for t in self._held] if pos is not None else None
        step = self.steps
        loss = self._step()
        if pos is not None:
            after = [p.detach().clone() for p in self.params]
            self.samples[pos] = (step, self._start(before, self._held_taken), loss, after)
        return loss

    def window(self) -> dict:
        ctx = self.ctx
        first = self.steps
        self.in_window = True
        ctx.window_started()
        start = time.perf_counter()
        deadline = start + ctx.seconds
        pending = None
        while True:
            loss = self._window_step(self.steps - first)
            if pending is not None:
                with ctx.tracer.span("fetch"):
                    float(pending)
            pending = loss
            if time.perf_counter() >= deadline:
                break
        with ctx.tracer.span("fetch"):
            float(pending)
        elapsed = time.perf_counter() - start
        ctx.window_closed()
        steps = self.steps - first
        self.samples["last"] = (self.steps - 1, self._start(self._held, self._held_taken),
                                pending, [p.detach() for p in self.params])
        return {"e2e": {"train_frames_per_s": steps * self.frames_per_step / elapsed},
                "counts": {"steps": steps, "frames": steps * self.frames_per_step,
                           "window_s": elapsed},
                "attempted": steps, "failed": 0}

    def judge(self) -> dict:
        ctx, tr = self.ctx, self.ctx.traffic
        del self.model, self.optimizer, self.step
        self.params = None
        self._stack.close()
        if ctx.cuda:
            torch.cuda.empty_cache()
        hyper = (ctx.cfg, tr["learning_rate"], tr["weight_decay"])
        batches = [self.pool[k % len(self.pool)].to(ctx.device)
                   for k in range(tr["checked_steps"])]
        ref_losses, ref_grads, ref_params = ref.train_steps(self.weights, batches, *hyper)
        losses, first, checked = self.losses, self.first_grad, self.checked
        if ctx.side == "control":
            losses, grads, checked = ref.train_steps(self.weights, batches, *hyper, numerics="tf32")
            first = {k: g + tr["weight_decay"] * self.weights[k] for k, g in grads.items()}
        out = numbers(losses, first, checked, ref_losses, ref_grads, ref_params, self.weights,
                      tr["weight_decay"])
        window_loss, window_change = 0.0, 0.0
        for step, start, loss, after in self.samples.values():
            u8 = [self.pool[step % len(self.pool)].to(ctx.device)]
            want_loss, want_grad, want = ref.train_steps(self.weights, u8, *hyper, start=start)
            loss = float(loss)
            if ctx.side == "control":
                (loss,), _, got = ref.train_steps(self.weights, u8, *hyper, start=start,
                                                  numerics="tf32")
                after = [got[k] for k in self.names]
            moved = list(judge.moved_leaves(want_grad))
            change = {k: a - start[0][k] for k, a in zip(self.names, after) if k in moved}
            ref_change = {k: want[k] - start[0][k] for k in moved}
            window_loss = max(window_loss, abs(loss - want_loss[0]) / abs(want_loss[0]))
            # the median leaf: the worst is a BatchNorm scale of 32-128 values whose gap swings
            window_change = max(window_change, judge.median_leaf_gap(change, ref_change, moved))
            print(f"window step {step}: loss gap {abs(loss - want_loss[0]) / abs(want_loss[0])!r}, "
                  f"worst leaf of the change {judge.worst_leaf(change, ref_change, moved)}, "
                  f"median leaf {judge.median_leaf_gap(change, ref_change, moved)!r}",
                  file=sys.stderr)
        out.update(window_loss_gap=window_loss, window_change_gap=window_change)
        return out


def numbers(losses, first_grad, checked, ref_losses, ref_grads, ref_params, w0,
            weight_decay) -> dict:
    """The compared numbers of the checked steps (module docstring)."""
    moved = list(judge.moved_leaves(ref_grads))
    ref_first = {k: g + weight_decay * w0[k] for k, g in ref_grads.items()}
    change = {k: checked[k] - w0[k] for k in moved}
    ref_change = {k: ref_params[k] - w0[k] for k in moved}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    for what, got, want in (("gradient", first_grad, ref_first), ("change", change, ref_change)):
        print(f"worst leaf of the {what}: {judge.worst_leaf(got, want, moved)}", file=sys.stderr)
    print(f"worst leaf's change gap (not compared): "
          f"{judge.norm_gap(change, ref_change, moved)!r}", file=sys.stderr)
    return {"loss_gap": loss_gap,
            "grad_gap": judge.norm_gap(first_grad, ref_first, moved),
            "change_gap": judge.median_leaf_gap(change, ref_change, moved)}


def prepare(ctx) -> CellRun:
    return CellRun(ctx)
