"""Video-model training loop (the JAX package's
``vad_tpu/train/video_trainer.py``, on one card or the CPU).

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
moments, and so does the port resuming a JAX checkpoint.

``train(args)`` builds the datasets from ``--data-dir``; ``fit(args,
train_ds, test_ds, device)`` is everything after, over any indexable
datasets of the same sample dicts.
"""

from __future__ import annotations

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
from vad_tpu_torch.train.state import (
    ReduceLROnPlateau,
    current_learning_rate,
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
from vad_tpu_torch.utils.profiling import MetricsLogger
from vad_tpu_torch.utils.weights import load_flax_variables, state_dict_to_flax

THRESHOLD_METHOD = "p99 of validation normal scores"
PATIENCE = 5

# Options of the JAX trainer whose modules the port does not have yet: (attribute,
# whether the value asks for it, flag, ROADMAP item).
_NOT_PORTED = (
    ("model_parallel", lambda v: int(v or 1) > 1, "--model-parallel > 1",
     "Queue 1 item 10 (scaling)"),
    ("tensorboard", bool, "--tensorboard", "Queue 1 item 11 (profiling)"),
    ("profile_dir", bool, "--profile-dir", "Queue 1 item 11 (profiling)"),
    ("debug_nans", bool, "--debug-nans", "Queue 1 item 11 (profiling)"),
)


def refuse_unported(args: Any) -> None:
    """Raise for an option whose module the port does not have yet."""
    for attr, asked, flag, item in _NOT_PORTED:
        if asked(getattr(args, attr, None)):
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP {item})")


def padded_batch_size(batch_size: int, accum_steps: int = 1) -> int:
    """Smallest multiple of ``accum_steps`` >= batch_size."""
    n = max(1, accum_steps)
    return ((batch_size + n - 1) // n) * n


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


def train(args: Any) -> Dict[str, Any]:
    """Build the IPAD datasets from ``args`` and run ``fit``."""
    device = resolve_device(getattr(args, "device", None))
    refuse_unported(args)
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
    ``--precision f32`` on the card, TF32 is off for the run."""
    device = resolve_device(device)
    refuse_unported(args)
    f32 = (getattr(args, "precision", "f32") or "f32") == "f32"
    with tf32_off(f32 and device.type == "cuda"):
        return _fit(args, train_ds, test_ds, device)


def _fit(args: Any, train_ds, test_ds, device: torch.device) -> Dict[str, Any]:
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"Using {device.type.upper()}: {name}")
    seed = int(getattr(args, "seed", 0) or 0)
    accum_steps = max(1, int(getattr(args, "accum_steps", 1) or 1))
    # train through the padded tail batch, cycled (see DistributedLoader);
    # the shuffle follows --seed
    train_loader = DistributedLoader(
        train_ds, args.batch_size, pad_to=padded_batch_size(args.batch_size, accum_steps),
        shuffle=True, num_workers=args.num_workers, seed=seed, device=device,
    )
    test_loader = DistributedLoader(test_ds, args.batch_size, num_workers=args.num_workers,
                                    device=device)

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
    train_step = make_train_step(per_sample_loss, compute_dtype, accum_steps)
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
        load_flax_variables(model, {"params": ckpt["params"],
                                    "batch_stats": ckpt.get("batch_stats") or {}})
        if ckpt.get("torch_opt_state") is not None:
            optimizer.load_state_dict(_to_tensors(ckpt["torch_opt_state"]))
        else:  # a JAX checkpoint: its optax state is not Adam's here
            print("  (no torch optimizer state in the checkpoint: Adam moments restart)")
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
        timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        results_dir = Path(args.results_dir) / f"video_{args.category}_{timestamp}"
        results_dir.mkdir(parents=True, exist_ok=True)

    args_dict = dict(vars(args))
    metrics = MetricsLogger(results_dir)
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
        train_loss = run_epoch_train(train_step, model, optimizer, train_loader)

        loss_sum, n_eval = 0.0, 0
        normal_err, anomaly_err, normal_frame_scores = [], [], []
        for batch, n_real in test_loader:
            losses, frame_scores = eval_step(model, batch["frames"])
            losses = losses.float().cpu().numpy()[:n_real]
            frame_scores = frame_scores.float().cpu().numpy()[:n_real]  # [B, T']
            scores = frame_scores.mean(axis=1)
            loss_sum += float(losses.mean())
            n_eval += 1
            labels = batch["label"][:n_real]
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
            save_checkpoint(results_dir / "best_model.ckpt", payload(
                epoch, torch_opt_state=optimizer.state_dict(), train_loss=train_loss,
                val_loss=val_loss, separation=separation, normal_err=nmean,
                anomaly_err=amean))
            print(f"  -> Saved best model (separation: {separation:.2f}x)", flush=True)
        else:
            no_improve += 1
        save_checkpoint(results_dir / f"checkpoint_epoch_{epoch}.ckpt",
                        payload(epoch, separation=separation))
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
        save_checkpoint(results_dir / "best_model.ckpt", payload(
            epoch, torch_opt_state=optimizer.state_dict(), train_loss=last("train_loss"),
            val_loss=last("val_loss"), separation=last("separation")))
        print("  (no separation improvement seen; saved final weights as best_model)")
    save_checkpoint(results_dir / "final_model.ckpt", payload(
        args.epochs, torch_opt_state=optimizer.state_dict(), history=history,
        best_epoch=best_epoch, best_separation=best_separation))

    if history["train_loss"]:
        plot_or_skip(plot_training_history, history, results_dir / "training_history.png")

    print("-" * 60)
    print("Training complete!")
    print(f"Best separation ratio: {best_separation:.2f}x at epoch {best_epoch}")
    print(f"Models saved to: {results_dir}")
    return {"model": model, "history": history, "results_dir": results_dir,
            "best_separation": best_separation, "best_epoch": best_epoch}
