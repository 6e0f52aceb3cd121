"""Image-model training loop (the JAX package's
``vad_tpu/train/image_trainer.py``), on one card, the CPU, or one process
per rank under ``torchrun`` (as the video trainer; the image model has no
gate weights to slice, so ``--model-parallel`` is data parallelism with
mp-fold duplicated rows, as in JAX).

mse, ssim or combined loss (``--loss``), Adam(lr, wd 1e-5),
ReduceLROnPlateau('min', factor 0.5, patience 5) on the validation loss,
and per epoch the test split's mean normal and anomaly reconstruction
errors and their separation.  The best checkpoint is the one with the
lowest validation loss; the final one is written at the end.  Training
runs through the padded tail batch (cycled, with the loss mask), the
shuffle follows ``--seed``, uint8 batches are normalized on the device,
and ``--precision bf16`` and ``--accum-steps`` work as in the video
trainer (``train/steps.py``).

Results land in ``<results_dir>/<category>_<timestamp>/``:
``best_model.ckpt`` and ``final_model.ckpt`` with the JAX trainer's keys
(``model_type: "image"``, the p99 ``score_threshold`` of the held-out
normal scores, their ``score_baseline`` and ``threshold_method``), the
weights in the JAX package's layout and the Adam state under
``torch_opt_state`` (as the video trainer writes them), ``metrics.jsonl``
and ``training_history.png``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.data.image_dataset import MVTecDataset
from vad_tpu_torch.data.loader import DistributedLoader
from vad_tpu_torch.eval.drift import score_baseline
from vad_tpu_torch.eval.metrics import calibrate_threshold
from vad_tpu_torch.eval.plots import plot_or_skip, plot_training_history
from vad_tpu_torch.models.autoencoder import ConvAutoencoder
from vad_tpu_torch.models.video_autoencoder import init_training_weights
from vad_tpu_torch.ops.losses import make_per_sample_loss_fn
from vad_tpu_torch.parallel.multihost import to_host
from vad_tpu_torch.parallel.sharding import distribute, padded_batch_size
from vad_tpu_torch.train.state import (
    ReduceLROnPlateau,
    current_learning_rate,
    make_optimizer,
    set_learning_rate,
)
from vad_tpu_torch.train.steps import make_eval_step, make_train_step
from vad_tpu_torch.train.video_trainer import (
    THRESHOLD_METHOD,
    main_rank_output,
    make_metrics,
    nan_debugging,
    new_results_dir,
    resume_state,
    run_epoch_train,
    run_profiled_epoch,
    save_on_main,
    training_mesh,
)
from vad_tpu_torch.utils.checkpoint import load_checkpoint
from vad_tpu_torch.utils.precision import tf32_off
from vad_tpu_torch.utils.weights import state_dict_to_flax


def run_epoch_validate(eval_step, model, loader, mesh=None):
    """(mean loss, mean normal score, mean anomaly score, labels, scores)
    over ``loader``'s real samples (each rank's rows gathered on a mesh)."""
    losses_sum, n_batches, all_scores, all_labels = 0.0, 0, [], []
    for batch, n_real in loader:
        losses, scores = eval_step(model, batch["image"])
        losses_sum += float(to_host(losses.float(), mesh)[:n_real].mean())
        n_batches += 1
        all_scores.append(to_host(scores.float(), mesh)[:n_real])
        all_labels.append(to_host(np.asarray(batch["label"]), mesh)[:n_real])
    scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
    labels = np.concatenate(all_labels) if all_labels else np.zeros(0, np.int64)
    normal, anomaly = scores[labels == 0], scores[labels == 1]
    return (losses_sum / max(n_batches, 1), float(normal.mean()) if len(normal) else 0.0,
            float(anomaly.mean()) if len(anomaly) else 0.0, labels, scores)


def train(args: Any) -> Dict[str, Any]:
    """Build the MVTec-format datasets from ``args`` and run ``fit``."""
    device = resolve_device(getattr(args, "device", None))
    print(f"\nLoading dataset: {args.category}")
    train_ds = MVTecDataset(args.data_dir, args.category, "train", args.image_size,
                            normalize=False)  # uint8 to the device
    test_ds = MVTecDataset(args.data_dir, args.category, "test", args.image_size,
                           normalize=False)
    print(f"Training samples: {len(train_ds)} (all normal)")
    print(f"Test samples: {len(test_ds)}")
    return fit(args, train_ds, test_ds, device)


def fit(args: Any, train_ds, test_ds, device=None) -> Dict[str, Any]:
    """Train on ``train_ds`` and select on ``test_ds`` (samples: dicts with
    uint8 ``image [H,W,3]`` and ``label``); returns the model, the history
    and the run directory.  With ``--precision f32`` on the card, TF32 is
    off for the run.  Under torchrun's environment this process is one
    rank (``video_trainer``'s docstring)."""
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
    train_loader = DistributedLoader(
        train_ds, args.batch_size, mesh=mesh,
        pad_to=padded_batch_size(args.batch_size, mesh, accum_steps), shuffle=True,
        num_workers=args.num_workers, seed=seed, device=device, accum_steps=accum_steps,
    )
    test_loader = DistributedLoader(test_ds, args.batch_size, mesh=mesh,
                                    num_workers=args.num_workers, device=device)

    model = ConvAutoencoder(in_channels=3, latent_dim=args.latent_dim,
                            norm=getattr(args, "norm", "batch"),
                            stem=getattr(args, "stem", "pool"), device="cpu")
    model = init_training_weights(model, seed).to(device)
    optimizer = make_optimizer(model.parameters(), args.lr, weight_decay=1e-5)

    loss_name = getattr(args, "loss", "mse") or "mse"
    ssim_weight = getattr(args, "ssim_weight", 0.5)
    per_sample_loss = make_per_sample_loss_fn(loss_name, ssim_weight)
    if loss_name == "mse":
        print("Using MSE loss")
    elif loss_name == "ssim":
        print("Using SSIM loss")
    else:
        print(f"Using Combined loss (MSE + SSIM, alpha={ssim_weight})")

    precision = getattr(args, "precision", "f32") or "f32"
    compute_dtype = torch.bfloat16 if precision == "bf16" else None
    if compute_dtype is not None:
        print("Precision: bf16 mixed (f32 master weights)")
    if accum_steps > 1:
        print(f"Gradient accumulation: {accum_steps} microbatches/step")
    train_step = make_train_step(per_sample_loss, compute_dtype, accum_steps,
                                 debug_nans=bool(getattr(args, "debug_nans", False)), mesh=mesh)
    eval_step = make_eval_step(per_sample_loss, ConvAutoencoder.reconstruction_error)
    scheduler = ReduceLROnPlateau(mode="min", factor=0.5, patience=5)

    start_epoch = 1
    history: Dict[str, list] = {"train_loss": [], "val_loss": [], "normal_err": [],
                                "anomaly_err": []}
    resume_path = getattr(args, "resume", None)
    if resume_path:
        ckpt = load_checkpoint(resume_path)
        resume_state(model, optimizer, ckpt)
        start_epoch = int(ckpt.get("epoch", 0)) + 1
        history = ckpt.get("history", history)
        print(f"Resumed from {resume_path} at epoch {start_epoch}")
        results_dir = Path(resume_path).parent
    else:
        results_dir = new_results_dir(mesh, args.results_dir, f"{args.category}_")
    distribute(model, mesh, optimizer)  # BatchNorm over the data group

    args_dict = dict(vars(args))
    metrics = make_metrics(mesh, results_dir, bool(getattr(args, "tensorboard", False)))
    print(f"\nStarting training for {args.epochs} epochs...")
    print("-" * 60)
    best_loss = min(history["val_loss"], default=float("inf"))
    payload = None

    for epoch in range(start_epoch, args.epochs + 1):
        t0 = time.time()
        train_loss = run_profiled_epoch(args, epoch, start_epoch, lambda: run_epoch_train(
            train_step, model, optimizer, train_loader, key="image"), main=mesh.is_main)
        val_loss, normal_err, anomaly_err, v_labels, v_scores = run_epoch_validate(
            eval_step, model, test_loader, mesh)

        new_lr = scheduler.step(val_loss, current_learning_rate(optimizer))
        if new_lr != current_learning_rate(optimizer):
            set_learning_rate(optimizer, new_lr)

        history["train_loss"].append(train_loss)
        history["val_loss"].append(val_loss)
        history["normal_err"].append(normal_err)
        history["anomaly_err"].append(anomaly_err)
        separation = anomaly_err / normal_err if normal_err > 0 else 0.0
        print(f"Epoch {epoch:3d}/{args.epochs} | Train Loss: {train_loss:.6f} | "
              f"Val Loss: {val_loss:.6f} | Normal Err: {normal_err:.6f} | "
              f"Anomaly Err: {anomaly_err:.6f} | Separation: {separation:.2f}x "
              f"({time.time() - t0:.1f}s)", flush=True)
        if epoch == start_epoch and device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(device)
            print(f"  device memory peak: {peak / 2**30:.2f} GiB", flush=True)
            metrics.log(epoch, device_peak_bytes=peak)
        metrics.log(epoch, train_loss=train_loss, val_loss=val_loss, normal_err=normal_err,
                    anomaly_err=anomaly_err, separation=separation,
                    lr=current_learning_rate(optimizer), epoch_seconds=time.time() - t0)

        normal_scores = v_scores[v_labels == 0]

        def payload(epoch=epoch, train_loss=train_loss, val_loss=val_loss,
                    normal_scores=normal_scores):
            return {
                "epoch": epoch, **state_dict_to_flax(model),
                "torch_opt_state": optimizer.state_dict(), "train_loss": train_loss,
                "val_loss": val_loss, "history": history, "args": args_dict,
                "model_type": "image", "score_threshold": calibrate_threshold(normal_scores),
                "score_baseline": score_baseline(normal_scores),
                "threshold_method": THRESHOLD_METHOD,
            }

        if val_loss < best_loss:
            best_loss = val_loss
            save_on_main(results_dir / "best_model.ckpt", payload, model, optimizer, mesh)
            print(f"  → Saved best model (loss: {val_loss:.6f})", flush=True)

    metrics.close()
    if payload is not None:
        save_on_main(results_dir / "final_model.ckpt",
                     lambda: {**payload(), "epoch": args.epochs}, model, optimizer, mesh)
    if history["train_loss"] and mesh.is_main:
        plot_or_skip(plot_training_history, history, results_dir / "training_history.png")

    print("-" * 60)
    print("Training complete!")
    print(f"Best validation loss: {best_loss:.6f}")
    if history["normal_err"] and history["normal_err"][-1] > 0:
        print(f"Final separation ratio: "
              f"{history['anomaly_err'][-1] / history['normal_err'][-1]:.2f}x")
    print(f"Models saved to: {results_dir}")
    return {"model": model, "history": history, "results_dir": results_dir}
