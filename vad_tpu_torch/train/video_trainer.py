"""Video-model training loop (the JAX package's
``vad_tpu/train/video_trainer.py``), on one card, the CPU, or one process
per rank under ``torchrun``.

MSE loss by default (``--loss``, ``--objective predict``), Adam(lr, wd
1e-5), ReduceLROnPlateau('max') on the separation ratio (mean anomaly
score over mean normal score of the test windows), the best checkpoint
chosen by the HIGHEST separation, a checkpoint every epoch, the two early
stops (no improvement for 5 epochs while separation < 1.0; separation <
0.8 after epoch 3), and p99 thresholds of held-out normal scores at
sequence and frame level with the frame-score baseline.

Results land in ``<results_dir>/video_<category>_<timestamp>/`` with the
JAX trainer's files and keys: ``best_model.ckpt``, ``final_model.ckpt``,
``checkpoint_epoch_N.ckpt`` and ``metrics.jsonl``.  ``params`` and
``batch_stats`` are written as the JAX package's tree (the reverse weight
bridge), so ``evaluate_video.py`` and the port's ``load_flax_variables``
both read them.  The Adam state goes under ``torch_opt_state``, not
``opt_state``: the JAX trainer resuming a port checkpoint restarts its
moments.  The port resuming a JAX checkpoint continues JAX's Adam
(``resume_state``): its moments, step count and learning rate.

``train(args)`` builds the datasets from ``--data-dir``; ``fit(args,
train_ds, test_ds, device)`` is everything after, over any indexable
datasets of the same sample dicts.

Scaling (``parallel/``): launched with torchrun's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ...) every process is a rank of a
``('data', 'model')`` mesh; ``--model-parallel N`` splits off the 'model'
axis, over which the ConvLSTM gate weights and their Adam moments are
sliced.  Each rank loads only its rows (``DistributedLoader``), the step
is the single-device program on the global batch, the epoch's metrics
come from ``to_host`` views (so every rank takes the same early-stopping
and best-epoch decisions), and only rank 0 writes checkpoints (the full
weights and moments, gathered), logs and TensorBoard.
"""

from __future__ import annotations

import contextlib
import os
import time
from datetime import datetime
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.data.loader import DistributedLoader
from vad_tpu_torch.data.video_dataset import detect_video_dataset_class
from vad_tpu_torch.eval.drift import score_baseline
from vad_tpu_torch.eval.metrics import calibrate_threshold
from vad_tpu_torch.eval.plots import plot_or_skip, plot_training_history
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder, init_training_weights
from vad_tpu_torch.ops.losses import make_per_sample_loss_fn
from vad_tpu_torch.parallel.multihost import to_host
from vad_tpu_torch.parallel.sharding import (
    MODEL_AXIS,
    barrier,
    broadcast_object,
    distribute,
    gathered,
    get_mesh,
    init_distributed,
    padded_batch_size,
)
from vad_tpu_torch.train.state import (
    ReduceLROnPlateau,
    current_learning_rate,
    load_optax_adam_state,
    make_optimizer,
    set_learning_rate,
)
from vad_tpu_torch.train.steps import make_eval_step, make_train_step
from vad_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    rotate_epoch_checkpoints,
    save_checkpoint,
)
from vad_tpu_torch.utils.precision import tf32_off
from vad_tpu_torch.utils.profiling import MetricsLogger, enable_nan_debugging, trace
from vad_tpu_torch.utils.weights import load_flax_variables, state_dict_to_flax

THRESHOLD_METHOD = "p99 of validation normal scores"
PATIENCE = 5

def training_mesh(args: Any, device: torch.device):
    """(mesh, this rank's device): the process group torchrun's environment
    describes, split by ``--model-parallel``; without one a one-device
    mesh, which has no 'model' axis to split (``--model-parallel 2``
    raises, as JAX's ``get_mesh`` does on one device)."""
    mp = int(getattr(args, "model_parallel", 1) or 1)
    rank_device = init_distributed(device)
    if rank_device is None:
        return get_mesh([device], model_parallel=mp), device
    mesh = get_mesh(model_parallel=mp)
    if mp > 1:
        print(f"Mesh: {mesh.shape} (tensor parallelism over '{MODEL_AXIS}')")
    return mesh, rank_device


@contextlib.contextmanager
def main_rank_output(mesh):
    """Standard output as it is on rank 0; other ranks print nothing."""
    if mesh.is_main:
        yield
        return
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        yield


class _NoMetrics:
    """What a rank other than 0 logs: nothing."""

    def log(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


def make_metrics(mesh, results_dir: Path, tensorboard: bool):
    return MetricsLogger(results_dir, tensorboard=tensorboard) if mesh.is_main else _NoMetrics()


def new_results_dir(mesh, results_root: str, prefix: str) -> Path:
    """``<results_root>/<prefix><timestamp>``, named and made by rank 0 and
    the same on every rank."""
    results_dir = None
    if mesh.is_main:
        timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        results_dir = Path(results_root) / f"{prefix}{timestamp}"
        results_dir.mkdir(parents=True, exist_ok=True)
    return Path(broadcast_object(results_dir, mesh))


def save_on_main(path: Path, make_payload, model, optimizer, mesh) -> None:
    """Rank 0 writes ``make_payload()``, built with the full weights and
    Adam moments (under tensor parallelism every rank takes part in
    gathering them); then every rank waits for the file."""
    with gathered(model, optimizer, mesh):
        if mesh.is_main:
            save_checkpoint(path, make_payload())
    barrier(mesh)


def nan_debugging(args: Any):
    """Autograd's anomaly mode for the run under ``--debug-nans`` (restored
    after it), else nothing."""
    if getattr(args, "debug_nans", False):
        return enable_nan_debugging(True)
    return contextlib.nullcontext()


def run_profiled_epoch(args: Any, epoch: int, start_epoch: int, run, main: bool = True):
    """``run()`` (one epoch's training), traced into ``--profile-dir`` on
    the second epoch of the run, as the JAX trainers trace the first epoch
    after compilation (on rank 0 only)."""
    profile_dir = getattr(args, "profile_dir", None) if main else None
    if not (profile_dir and epoch == start_epoch + 1):
        return run()
    with trace(profile_dir):
        out = run()
    print(f"  (profiler trace written to {profile_dir})")
    return out


def run_epoch_train(train_step, model, optimizer, loader, key: str = "frames") -> float:
    """One epoch of ``train_step`` over ``loader``'s ``key`` batches; the mean
    loss.  Each loss is read one step late, so host and device overlap."""
    total, n_batches, pending = 0.0, 0, None
    for batch, n_real in loader:
        loss = train_step(model, optimizer, batch[key], n_real)
        if pending is not None:
            total += float(pending)
        pending = loss
        n_batches += 1
    if pending is not None:
        total += float(pending)
    return total / max(n_batches, 1)


def _to_tensors(tree: Any) -> Any:
    """numpy leaves of a stored optimizer state -> tensors."""
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_tensors(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree)
    return tree


def resume_state(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 ckpt: Dict[str, Any]) -> None:
    """Load a checkpoint's weights into ``model`` and its optimizer state
    into ``optimizer``: the port's own Adam state (``torch_opt_state``),
    else the JAX package's optax state (``opt_state``: moments, step count
    and learning rate), else Adam starts afresh (a checkpoint that holds
    neither, as the per-epoch ones)."""
    stats = ckpt.get("batch_stats") or {}
    load_flax_variables(model, {"params": ckpt["params"], "batch_stats": stats})
    if ckpt.get("torch_opt_state") is not None:
        optimizer.load_state_dict(_to_tensors(ckpt["torch_opt_state"]))
    elif ckpt.get("opt_state") is not None:
        load_optax_adam_state(optimizer, model, ckpt["opt_state"], stats)
        print(f"  (Adam state from the checkpoint's optax state: step "
              f"{int(optimizer.state_dict()['state'][0]['step'])}, "
              f"lr {current_learning_rate(optimizer):g})")
    else:
        print("  (no optimizer state in the checkpoint: Adam moments restart)")


def train(args: Any) -> Dict[str, Any]:
    """Build the IPAD datasets from ``args`` and run ``fit``."""
    device = resolve_device(getattr(args, "device", None))
    print(f"\nLoading video dataset: {args.category}")
    dataset_class = detect_video_dataset_class(args.data_dir, args.category)
    print(f"Using dataset loader: {dataset_class.__name__}")
    common = dict(sequence_length=args.sequence_length, stride=args.stride,
                  image_size=args.image_size, normalize=False)  # u8 to the device
    train_ds = dataset_class(args.data_dir, args.category, "train", **common)
    test_ds = dataset_class(args.data_dir, args.category, "test", **common)
    print(f"Training sequences: {len(train_ds)} (all normal)")
    print(f"Test sequences: {len(test_ds)}")
    return fit(args, train_ds, test_ds, device)


def fit(args: Any, train_ds, test_ds, device=None) -> Dict[str, Any]:
    """Train on ``train_ds`` and select on ``test_ds`` (samples: dicts with
    uint8 ``frames [T,H,W,3]`` and ``label``); returns the model, the
    history, the run directory and the best separation and epoch.  With
    ``--precision f32`` on the card, TF32 is off for the run.  Under
    torchrun's environment this process is one rank (module docstring)."""
    mesh, device = training_mesh(args, resolve_device(device))
    f32 = (getattr(args, "precision", "f32") or "f32") == "f32"
    with tf32_off(f32 and device.type == "cuda"), nan_debugging(args), \
            main_rank_output(mesh):
        return _fit(args, train_ds, test_ds, device, mesh)


def _fit(args: Any, train_ds, test_ds, device: torch.device, mesh) -> Dict[str, Any]:
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"Using {device.type.upper()}: {name}")
    seed = int(getattr(args, "seed", 0) or 0)
    accum_steps = max(1, int(getattr(args, "accum_steps", 1) or 1))
    # train through the padded tail batch, cycled (see DistributedLoader);
    # the shuffle follows --seed
    train_loader = DistributedLoader(
        train_ds, args.batch_size, mesh=mesh,
        pad_to=padded_batch_size(args.batch_size, mesh, accum_steps), shuffle=True,
        num_workers=args.num_workers, seed=seed, device=device, accum_steps=accum_steps,
    )
    test_loader = DistributedLoader(test_ds, args.batch_size, mesh=mesh,
                                    num_workers=args.num_workers, device=device)

    model = VideoAutoencoder(
        in_channels=3, latent_dim=args.latent_dim, lstm_hidden_dim=args.lstm_hidden_dim,
        lstm_layers=args.lstm_layers, norm=getattr(args, "norm", "batch"),
        stem=getattr(args, "stem", "pool"), remat=bool(getattr(args, "remat", False)),
        device="cpu",
    )
    model = init_training_weights(model, seed).to(device)
    print(f"Model parameters: {sum(p.numel() for p in model.parameters()):,}")

    loss_name = getattr(args, "loss", "mse") or "mse"
    per_sample_loss = make_per_sample_loss_fn(loss_name, getattr(args, "ssim_weight", 0.5))
    if loss_name != "mse":
        print(f"Using {loss_name} loss")
    objective = getattr(args, "objective", "reconstruct") or "reconstruct"
    if objective == "predict":
        # output t is causal in frames <= t; train it to match frame t+1
        print("Objective: future-frame prediction")
        base_loss = per_sample_loss
        per_sample_loss = lambda recon, x: base_loss(recon[:, :-1], x[:, 1:])  # noqa: E731
        score_method = VideoAutoencoder.prediction_error
    else:
        score_method = VideoAutoencoder.reconstruction_error

    optimizer = make_optimizer(model.parameters(), args.lr, weight_decay=1e-5)
    precision = getattr(args, "precision", "f32") or "f32"
    compute_dtype = torch.bfloat16 if precision == "bf16" else None
    if compute_dtype is not None:
        print("Precision: bf16 mixed (f32 master weights)")
    if accum_steps > 1:
        print(f"Gradient accumulation: {accum_steps} microbatches/step")
    train_step = make_train_step(per_sample_loss, compute_dtype, accum_steps,
                                 debug_nans=bool(getattr(args, "debug_nans", False)), mesh=mesh)
    # frame scores on the device; the sequence score is their mean (the
    # frame granularity is what serving flags against)
    eval_step = make_eval_step(per_sample_loss,
                               lambda m, x: score_method(m, x, per_frame=True))
    scheduler = ReduceLROnPlateau(mode="max", factor=0.5, patience=PATIENCE)

    start_epoch, history = 1, None
    best_separation, best_epoch = 0.0, 0
    resume_path = getattr(args, "resume", None)
    if resume_path:
        ckpt = load_checkpoint(resume_path)
        resume_state(model, optimizer, ckpt)
        start_epoch = int(ckpt.get("epoch", 0)) + 1
        results_dir = Path(resume_path).parent
        # carry the selection state forward so a worse post-resume epoch
        # cannot clobber the saved best checkpoint
        history = ckpt.get("history")
        if history and history.get("separation"):
            best_separation = max(history["separation"])
            best_epoch = history["separation"].index(best_separation) + 1
        else:
            best_separation = float(ckpt.get("best_separation", ckpt.get("separation", 0.0))
                                    or 0.0)
            best_epoch = int(ckpt.get("best_epoch", ckpt.get("epoch", 0)) or 0)
        print(f"Resumed from {resume_path} at epoch {start_epoch} "
              f"(best separation so far: {best_separation:.2f}x)")
    else:
        results_dir = new_results_dir(mesh, args.results_dir, f"video_{args.category}_")
    # the gate weights and their moments to this rank's slices (tensor
    # parallelism), BatchNorm over the data group
    distribute(model, mesh, optimizer)

    args_dict = dict(vars(args))
    metrics = make_metrics(mesh, results_dir, bool(getattr(args, "tensorboard", False)))
    history = history or {"train_loss": [], "val_loss": [], "normal_err": [],
                          "anomaly_err": [], "separation": []}
    print(f"\nStarting training for {args.epochs} epochs...")
    print(f"Sequence length: {args.sequence_length} frames")
    print("\n*** SAVING BASED ON SEPARATION RATIO (not loss) ***")
    print("-" * 60)

    def payload(epoch: int, **extra) -> Dict[str, Any]:
        return {"epoch": epoch, **state_dict_to_flax(model), **extra, "args": args_dict,
                "model_type": "video", "score_threshold": score_threshold,
                "frame_score_threshold": frame_score_threshold,
                "score_baseline": frame_score_baseline, "threshold_method": THRESHOLD_METHOD}

    no_improve = 0
    epoch = start_epoch - 1
    score_threshold = frame_score_threshold = frame_score_baseline = None
    for epoch in range(start_epoch, args.epochs + 1):
        t0 = time.time()
        train_loss = run_profiled_epoch(args, epoch, start_epoch, lambda: run_epoch_train(
            train_step, model, optimizer, train_loader), main=mesh.is_main)

        loss_sum, n_eval = 0.0, 0
        normal_err, anomaly_err, normal_frame_scores = [], [], []
        for batch, n_real in test_loader:
            losses, frame_scores = eval_step(model, batch["frames"])
            losses = to_host(losses.float(), mesh)[:n_real]
            frame_scores = to_host(frame_scores.float(), mesh)[:n_real]  # [B, T']
            scores = frame_scores.mean(axis=1)
            loss_sum += float(losses.mean())
            n_eval += 1
            labels = to_host(np.asarray(batch["label"]), mesh)[:n_real]
            normal_err.extend(scores[labels == 0].tolist())
            anomaly_err.extend(scores[labels == 1].tolist())
            # every frame of a NORMAL window is normal
            normal_frame_scores.extend(frame_scores[labels == 0].ravel().tolist())
        val_loss = loss_sum / max(n_eval, 1)
        nmean = float(np.mean(normal_err)) if normal_err else 0.0
        amean = float(np.mean(anomaly_err)) if anomaly_err else 0.0
        separation = amean / nmean if nmean > 0 else 0.0
        score_threshold = calibrate_threshold(normal_err)
        frame_score_threshold = calibrate_threshold(normal_frame_scores)
        frame_score_baseline = score_baseline(normal_frame_scores)

        new_lr = scheduler.step(separation, current_learning_rate(optimizer))
        if new_lr != current_learning_rate(optimizer):
            set_learning_rate(optimizer, new_lr)

        for key, value in (("train_loss", train_loss), ("val_loss", val_loss),
                           ("normal_err", nmean), ("anomaly_err", amean),
                           ("separation", separation)):
            history[key].append(value)
        status = " <- BEST" if separation > best_separation else (
            " (inverted!)" if separation < 1.0 else "")
        print(f"Epoch {epoch:3d}/{args.epochs} | Train Loss: {train_loss:.6f} | "
              f"Val Loss: {val_loss:.6f} | Normal: {nmean:.6f} | Anomaly: {amean:.6f} | "
              f"Separation: {separation:.2f}x{status} ({time.time() - t0:.1f}s)", flush=True)
        if epoch == start_epoch and device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(device)
            print(f"  device memory peak: {peak / 2**30:.2f} GiB", flush=True)
            metrics.log(epoch, device_peak_bytes=peak)
        metrics.log(epoch, train_loss=train_loss, val_loss=val_loss, normal_err=nmean,
                    anomaly_err=amean, separation=separation,
                    lr=current_learning_rate(optimizer), epoch_seconds=time.time() - t0)

        if separation > best_separation:
            best_separation, best_epoch, no_improve = separation, epoch, 0
            save_on_main(results_dir / "best_model.ckpt", lambda: payload(
                epoch, torch_opt_state=optimizer.state_dict(), train_loss=train_loss,
                val_loss=val_loss, separation=separation, normal_err=nmean,
                anomaly_err=amean), model, optimizer, mesh)
            print(f"  -> Saved best model (separation: {separation:.2f}x)", flush=True)
        else:
            no_improve += 1
        save_on_main(results_dir / f"checkpoint_epoch_{epoch}.ckpt",
                     lambda: payload(epoch, separation=separation), model, optimizer, mesh)
        if mesh.is_main:
            rotate_epoch_checkpoints(results_dir, int(getattr(args, "keep_checkpoints", 0) or 0))

        if no_improve >= PATIENCE and separation < 1.0:
            print(f"\n*** Early stopping: Separation below 1.0 for {PATIENCE} epochs ***")
            print(f"*** Best model was at epoch {best_epoch} with "
                  f"{best_separation:.2f}x separation ***")
            break
        if separation < 0.8 and epoch > 3:
            print(f"\n*** Stopping: Separation inverted to {separation:.2f}x "
                  f"(anomalies reconstructed better than normal) ***")
            print(f"*** Best model saved at epoch {best_epoch} with "
                  f"{best_separation:.2f}x separation ***")
            break

    if best_epoch == 0:
        # no epoch improved separation: still leave a usable best checkpoint
        last = lambda k: history[k][-1] if history[k] else 0.0  # noqa: E731
        save_on_main(results_dir / "best_model.ckpt", lambda: payload(
            epoch, torch_opt_state=optimizer.state_dict(), train_loss=last("train_loss"),
            val_loss=last("val_loss"), separation=last("separation")), model, optimizer, mesh)
        print("  (no separation improvement seen; saved final weights as best_model)")
    save_on_main(results_dir / "final_model.ckpt", lambda: payload(
        args.epochs, torch_opt_state=optimizer.state_dict(), history=history,
        best_epoch=best_epoch, best_separation=best_separation), model, optimizer, mesh)

    metrics.close()
    if history["train_loss"] and mesh.is_main:
        plot_or_skip(plot_training_history, history, results_dir / "training_history.png")

    print("-" * 60)
    print("Training complete!")
    print(f"Best separation ratio: {best_separation:.2f}x at epoch {best_epoch}")
    print(f"Models saved to: {results_dir}")
    return {"model": model, "history": history, "results_dir": results_dir,
            "best_separation": best_separation, "best_epoch": best_epoch}
