"""Video-model evaluation in dataset mode (the JAX package's
``vad_tpu/eval/video_eval.py``): sequence AUROC over non-overlapping
windows (stride = sequence length), frame AUROC where per-frame labels
exist, average precision, score statistics and separation, the ROC and
score-distribution plots, side-by-side visualization PNGs, and
``results.txt`` in the JAX evaluator's format.

``--scorer latent`` scores by the latent-distance scorer
(``eval/latent_score.py``) instead of the reconstruction error: per-position
Gaussians fitted on the training split's frames (or read from
``--latent-stats``; the fit is written to ``evaluation/latent_stats.npz``),
a frame's score the mean of its Mahalanobis map.  It is purely spatial, so
it ignores the ConvLSTM and the training objective.

Frames stay uint8 to the device and are normalized there; scoring runs in
f32 with TF32 off on the card (so its scores hold the f32 bar), the
recurrence through kernel 1.  ``score_windows`` is the scoring loop alone,
over any object with the dataset interface.  One forward pass gives both
scores: the sequence score is the mean of the frame scores (the JAX
evaluator runs the model twice for the same two numbers).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from vad_tpu_torch.core.config import VideoAEConfig
from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.data.loader import DistributedLoader
from vad_tpu_torch.data.video_dataset import cv2_module, detect_video_dataset_class
from vad_tpu_torch.eval.latent_score import (
    fit_or_load,
    make_distance_fn,
    stats_state,
    upsample_maps,
)
from vad_tpu_torch.eval.metrics import auroc, average_precision
from vad_tpu_torch.eval.plots import (
    plot_or_skip,
    plot_roc_curve,
    plot_score_distribution,
    save_image_png,
)
from vad_tpu_torch.models.video_autoencoder import VideoAutoencoder
from vad_tpu_torch.train.steps import u8_normalize
from vad_tpu_torch.utils.checkpoint import load_checkpoint
from vad_tpu_torch.utils.precision import tf32_off
from vad_tpu_torch.utils.weights import load_flax_variables

SCORE_MODES = ("mean", "max", "p99")

# Options of the JAX evaluator whose modules the port does not have yet:
# (attribute, whether the value asks for it, flag, ROADMAP item).
_NOT_PORTED = (
    ("data_parallel", bool, "--data-parallel", "Queue 1 item 10 (scaling)"),
)


def refuse_unported(args: Any) -> None:
    """Raise for an option whose module the port does not have yet."""
    for attr, asked, flag, item in _NOT_PORTED:
        if asked(getattr(args, attr, None)):
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP {item})")


def smooth_frame_scores(frame_scores: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian-smooth per-frame scores [B, T] along time (sigma in frames,
    edges replicated), so max/p99 aggregation answers sustained anomalous
    segments rather than one flickering frame."""
    size = max(3, int(2 * round(2 * sigma) + 1))
    x = np.arange(size, dtype=np.float64) - size // 2
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    pad = size // 2
    fp = np.pad(np.asarray(frame_scores, np.float64), ((0, 0), (pad, pad)), mode="edge")
    return np.stack([np.convolve(row, k, mode="valid") for row in fp])


def aggregate_sequence_scores(frame_scores: np.ndarray, score_mode: str = "mean",
                              score_smooth: float = 0.0) -> np.ndarray:
    """Per-frame scores [B, T] -> sequence scores [B]: their mean (the
    reference's whole-window score), max or 99th percentile, after the
    temporal smoothing when ``score_smooth`` > 0."""
    if score_mode not in SCORE_MODES:
        raise ValueError(f"score_mode must be one of {SCORE_MODES}, got {score_mode!r}")
    f = np.asarray(frame_scores, np.float64)
    if score_smooth > 0:
        f = smooth_frame_scores(f, score_smooth)
    if score_mode == "max":
        return f.max(axis=1)
    if score_mode == "p99":
        return np.quantile(f, 0.99, axis=1)
    return f.mean(axis=1)


def denormalize_u8(arr: np.ndarray) -> np.ndarray:
    """[-1,1] float -> [0,255] uint8."""
    return (np.clip(np.asarray(arr) * 0.5 + 0.5, 0.0, 1.0) * 255).astype(np.uint8)


def create_heatmap(error_map: np.ndarray, size=None) -> np.ndarray:
    """Error map -> JET RGB heatmap (min-max scaled), resized to ``size``."""
    cv2 = cv2_module()
    e = np.asarray(error_map, dtype=np.float32)
    e = (e - e.min()) / (e.max() - e.min() + 1e-8)
    u8 = (e * 255).astype(np.uint8)
    hm = cv2.cvtColor(cv2.applyColorMap(u8, cv2.COLORMAP_JET), cv2.COLOR_BGR2RGB)
    if size:
        hm = cv2.resize(hm, size)
    return hm


def load_video_model(checkpoint_path: str | Path, device=None
                     ) -> Tuple[VideoAutoencoder, Dict, Dict]:
    """(model in eval mode on ``device``, its JAX-layout variables, the
    checkpoint's ``args``) from a ``.ckpt`` of either package.  ``device``
    ``None`` means CUDA."""
    ckpt = load_checkpoint(checkpoint_path)
    saved = ckpt.get("args", {})
    model = VideoAutoencoder.from_config(VideoAEConfig.from_args(saved), device=device)
    variables = {"params": ckpt["params"], "batch_stats": ckpt.get("batch_stats") or {}}
    load_flax_variables(model, variables).eval()
    print(f"Loaded model from epoch {ckpt.get('epoch', 'unknown')}")
    print(f"Training loss: {ckpt.get('train_loss', 0) or 0:.6f}")
    return model, variables, saved


def _score_method(objective: str):
    return (VideoAutoencoder.prediction_error if objective == "predict"
            else VideoAutoencoder.reconstruction_error)


def score_windows(model: VideoAutoencoder, dataset, batch_size: int = 4,
                  objective: str = "reconstruct", frame_maps_fn=None,
                  scorer_state=None) -> Dict[str, Any]:
    """Score every window of ``dataset`` (``__len__``, ``__getitem__`` ->
    {"frames" uint8 [T,H,W,3], "label", "frame_labels"}, ``labels``,
    ``has_frame_labels``) in batches of ``batch_size`` on the model's
    device, in eval mode.  ``frame_maps_fn(model, scorer_state, frames
    [N,H,W,C]) -> [N,G,G]`` (the latent scorer, ``latent_frame_maps``)
    replaces the reconstruction error: a frame's score is its map's mean.

    Returns float64 numpy arrays: ``sequence`` [N] (the mean of each
    window's frame scores), ``frame`` [N, T'] (T' = T, or T-1 aligned to
    frames 1..T-1 for ``objective='predict'``), ``labels`` [N] and
    ``frame_labels`` [N, T'] (None without per-frame labels)."""
    device = model.device
    method = _score_method(objective)
    has_frame_labels = getattr(dataset, "has_frame_labels", False)
    loader = DistributedLoader(dataset, batch_size, num_workers=2, device=device)
    seqs, frames, labels, frame_labels = [], [], [], []
    model.eval()
    with torch.no_grad(), tf32_off(device.type == "cuda"):
        for batch, n_real in loader:
            x = u8_normalize(batch["frames"])
            if frame_maps_fn is not None:
                maps = frame_maps_fn(model, scorer_state, x.flatten(0, 1))
                frame = maps.mean(dim=(1, 2)).reshape(x.shape[:2])[:n_real]
            else:
                frame = method(model, x, per_frame=True)[:n_real]
            seqs.append(frame.mean(dim=1).cpu().numpy())
            frames.append(frame.cpu().numpy())
            labels.append(np.asarray(batch["label"])[:n_real])
            if has_frame_labels:
                fl = np.asarray(batch["frame_labels"])[:n_real]
                frame_labels.append(fl[:, 1:] if objective == "predict" else fl)
    cat = lambda parts, dtype: np.concatenate(parts).astype(dtype)  # noqa: E731
    return {"sequence": cat(seqs, np.float64), "frame": cat(frames, np.float64),
            "labels": cat(labels, np.int64),
            "frame_labels": cat(frame_labels, np.int64) if has_frame_labels else None}


def latent_frame_maps(model: VideoAutoencoder, train_ds, batch_size: int = 4,
                      proj_dim: int = 128, grid=None, save_path=None, load_path=None):
    """Fit the latent scorer on every frame of ``train_ds``'s windows (or
    load it from ``load_path``); returns ``(frame_maps_fn, scorer_state)``,
    ``frame_maps_fn(model, state, frames [N,H,W,C]) -> [N,G,G]``."""
    def pyramid_fn(m, frames):
        return m.feature_pyramid(frames)

    device = model.device
    model.eval()
    loader = DistributedLoader(train_ds, batch_size, num_workers=2, device=device)
    frames = (u8_normalize(b["frames"][:n]).flatten(0, 1) for b, n in loader)  # [B*T,H,W,C]
    with tf32_off(device.type == "cuda"):
        stats = fit_or_load(pyramid_fn, model, frames, proj_dim=proj_dim, grid=grid, seed=0,
                            save_path=save_path, load_path=load_path, what="frames")
    return make_distance_fn(pyramid_fn, stats.layers, stats.grid), stats_state(stats, device)


def evaluate(args: Any) -> float:
    """Dataset-mode evaluation of ``args.checkpoint`` on the test split;
    writes ``<checkpoint dir>/evaluation/`` and returns the sequence
    AUROC (0.0 when the split has one class)."""
    refuse_unported(args)
    device = resolve_device(getattr(args, "device", None))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"Using device: {device.type}:{name}")

    model, _, saved = load_video_model(args.checkpoint, device)
    category = args.category or saved.get("category", "S01")
    sequence_length = int(saved.get("sequence_length", 16))
    image_size = int(saved.get("image_size", 256))

    print(f"\nEvaluating on category: {category}")
    dataset_class = detect_video_dataset_class(args.data_dir, category)
    test_ds = dataset_class(args.data_dir, category, "test", sequence_length=sequence_length,
                            stride=sequence_length,  # non-overlapping for evaluation
                            image_size=image_size, normalize=False)  # u8 to the device
    print(f"Test sequences: {len(test_ds)}")

    objective = saved.get("objective", "reconstruct") or "reconstruct"
    scorer = getattr(args, "scorer", "recon") or "recon"
    eval_dir = Path(args.checkpoint).parent / "evaluation"
    eval_dir.mkdir(exist_ok=True)
    frame_maps_fn = scorer_state = None
    if scorer == "latent":
        objective = "reconstruct"  # latent maps align 1:1 with frames
        train_ds = dataset_class(args.data_dir, category, "train",
                                 sequence_length=sequence_length, stride=sequence_length,
                                 image_size=image_size, normalize=False)
        load_path = getattr(args, "latent_stats", None)
        print("Latent-distance scorer:" if load_path else
              f"Latent-distance scorer: fitting per-position Gaussians on "
              f"{len(train_ds)} normal training windows...")
        frame_maps_fn, scorer_state = latent_frame_maps(
            model, train_ds, args.batch_size,
            proj_dim=int(getattr(args, "latent_proj_dim", 128) or 128),
            grid=getattr(args, "latent_grid", None), save_path=eval_dir / "latent_stats.npz",
            load_path=load_path)
    elif objective == "predict":
        print("Scoring objective: future-frame prediction error")
    score_mode = getattr(args, "score_mode", None) or "mean"
    score_smooth = float(getattr(args, "score_smooth", 0.0) or 0.0)
    custom_agg = score_mode != "mean" or score_smooth > 0
    if custom_agg:
        print(f"Sequence score: {score_mode} over frame scores"
              + (f" (temporal gaussian sigma={score_smooth})" if score_smooth > 0 else ""))

    print("\nComputing anomaly scores...")
    scored = score_windows(model, test_ds, args.batch_size, objective, frame_maps_fn,
                           scorer_state)
    all_labels = scored["labels"]
    all_scores = (aggregate_sequence_scores(scored["frame"], score_mode, score_smooth)
                  if custom_agg else scored["sequence"])
    frame_scores = frame_labels = None
    if scored["frame_labels"] is not None:
        f = scored["frame"]
        if score_smooth > 0:  # frame metrics see the scores the aggregation used
            f = smooth_frame_scores(f, score_smooth)
        frame_scores, frame_labels = f.reshape(-1), scored["frame_labels"].reshape(-1)

    print("\n" + "=" * 50)
    seq_ap = None
    if len(np.unique(all_labels)) > 1:
        a = auroc(all_labels, all_scores)
        seq_ap = average_precision(all_labels, all_scores)
        print(f"Sequence-level AUROC: {a:.4f}")
        print(f"Sequence-level AP (AUPRC): {seq_ap:.4f}")
    else:
        a = 0.0
        print("Cannot compute AUROC - only one class present")

    frame_auroc = frame_ap = None
    if frame_labels is not None and len(np.unique(frame_labels)) > 1:
        frame_auroc = auroc(frame_labels, frame_scores)
        frame_ap = average_precision(frame_labels, frame_scores)
        print(f"Frame-level AUROC: {frame_auroc:.4f}")
        print(f"Frame-level AP (AUPRC): {frame_ap:.4f}")

    normal = all_scores[all_labels == 0]
    anomaly = all_scores[all_labels == 1]
    print("=" * 50)
    print("\nScore Statistics:")
    print(f"  Normal  - mean: {normal.mean():.6f}, std: {normal.std():.6f}")
    if len(anomaly) > 0:
        print(f"  Anomaly - mean: {anomaly.mean():.6f}, std: {anomaly.std():.6f}")
        print(f"  Separation ratio: {anomaly.mean() / normal.mean():.2f}x")

    if len(np.unique(all_labels)) > 1:
        print()
        plot_or_skip(plot_roc_curve, all_labels, all_scores, eval_dir / "roc_curve.png",
                     title=f"ROC Curve - Video Anomaly Detection\n{category}", fontsize=None,
                     diagonal_label=None)
    plot_or_skip(plot_score_distribution, all_labels, all_scores,
                 eval_dir / "score_distribution.png", xlabel="Anomaly Score",
                 title=f"Score Distribution - {category}", fontsize=None, count_in_label=False,
                 plot_empty_anomaly=False)

    print("\nGenerating visualizations...")
    generate_visualizations(model, test_ds, eval_dir, num_samples=4, objective=objective,
                            frame_maps_fn=frame_maps_fn, scorer_state=scorer_state)

    with open(eval_dir / "results.txt", "w") as f:
        f.write("Video Anomaly Detection Evaluation\n")
        f.write("=" * 50 + "\n\n")
        f.write(f"Category: {category}\n")
        if scorer != "recon":
            f.write(f"Scorer: {scorer}\n")
        if custom_agg:
            f.write(f"Sequence score mode: {score_mode}"
                    + (f" (temporal gaussian sigma={score_smooth})" if score_smooth > 0 else "")
                    + "\n")
        f.write(f"Sequence-level AUROC: {a:.4f}\n")
        if frame_auroc is not None:
            f.write(f"Frame-level AUROC: {frame_auroc:.4f}\n")
        if seq_ap is not None:
            f.write(f"Sequence-level AP (AUPRC): {seq_ap:.4f}\n")
        if frame_ap is not None:
            f.write(f"Frame-level AP (AUPRC): {frame_ap:.4f}\n")
        f.write(f"Test sequences: {len(test_ds)}\n")
        f.write(f"  Normal: {len(normal)}\n")
        f.write(f"  Anomaly: {len(anomaly)}\n\n")
        f.write("Score Statistics:\n")
        f.write(f"  Normal mean: {normal.mean():.6f}\n")
        if len(anomaly) > 0:
            f.write(f"  Anomaly mean: {anomaly.mean():.6f}\n")
            f.write(f"  Separation: {anomaly.mean() / normal.mean():.2f}x\n")

    print(f"\nResults saved to: {eval_dir}")
    return a


def generate_visualizations(model: VideoAutoencoder, dataset, output_dir: Path,
                            num_samples: int = 4, objective: str = "reconstruct",
                            frame_maps_fn=None, scorer_state=None) -> None:
    """Side-by-side PNGs (original | reconstruction | error heatmap) of the
    middle frame of a few normal and anomalous windows of ``dataset``
    (uint8 frames).  For a predict-trained model the panels and the score
    use the prediction error (output t against frame t+1), as the metrics
    do.  With ``frame_maps_fn`` (the latent scorer) the heatmap and the
    score are its maps, upsampled to the frame."""
    cv2 = cv2_module()
    labels = dataset.labels
    normal_idx = [i for i, lab in enumerate(labels) if lab == 0][: num_samples // 2]
    anomaly_idx = [i for i, lab in enumerate(labels) if lab == 1][: num_samples // 2]
    selected = normal_idx + anomaly_idx or list(range(min(num_samples, len(dataset))))
    method = _score_method(objective)
    device = model.device
    model.eval()
    for idx in selected:
        sample = dataset[idx]
        label = int(sample["label"])
        label_name = "ANOMALY" if label == 1 else "NORMAL"
        with torch.no_grad(), tf32_off(device.type == "cuda"):
            x = u8_normalize(torch.as_tensor(sample["frames"][None], device=device))
            recon = model(x)
            if frame_maps_fn is not None:
                maps = frame_maps_fn(model, scorer_state, x.flatten(0, 1))
                err = upsample_maps(maps, x.shape[2]).reshape(x.shape[:4])
            else:
                err = method(model, x, per_pixel=True)
            seq = err.mean(dim=(1, 2, 3))
        frames, recon, err = x[0].cpu().numpy(), recon[0].cpu().numpy(), err[0].cpu().numpy()

        t_mid = err.shape[0] // 2  # err has T-1 frames in predict mode
        # predict mode: the panel shows frame t_mid+1 beside its prediction recon[t_mid]
        t_show = t_mid + 1 if objective == "predict" else t_mid
        orig = denormalize_u8(frames[t_show])
        rec = denormalize_u8(recon[t_mid])
        heat = create_heatmap(err[t_mid], size=orig.shape[1::-1])
        combined = cv2.cvtColor(np.hstack([orig, rec, heat]), cv2.COLOR_RGB2BGR)
        w = orig.shape[1]
        middle_title = "Prediction" if objective == "predict" else "Reconstruction"
        white = (255, 255, 255)
        cv2.putText(combined, "Original", (10, 25), cv2.FONT_HERSHEY_SIMPLEX, 0.7, white, 2)
        cv2.putText(combined, middle_title, (w + 10, 25), cv2.FONT_HERSHEY_SIMPLEX, 0.7, white, 2)
        heat_title = "Latent Distance" if frame_maps_fn is not None else "Error Heatmap"
        cv2.putText(combined, heat_title, (2 * w + 10, 25), cv2.FONT_HERSHEY_SIMPLEX, 0.7,
                    white, 2)
        cv2.putText(combined, f"{label_name} | Score: {float(seq[0]):.4f}",
                    (10, combined.shape[0] - 6), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                    (0, 255, 0) if label == 0 else (0, 0, 255), 2)
        combined = cv2.cvtColor(combined, cv2.COLOR_BGR2RGB)
        plot_or_skip(save_image_png, combined,
                     output_dir / f"visualization_{idx}_{label_name.lower()}.png")
    print(f"Saved {len(selected)} visualizations")
