"""Evaluation artifacts: ROC curve, score histograms, reconstruction grid
and training history (a copy of the JAX package's ``vad_tpu/eval/plots.py``,
same file names and styling).

matplotlib is imported at the first plot, with the Agg backend, never at
module import.  ``plot_or_skip`` is how the trainer and the evaluator draw:
where matplotlib cannot be imported it prints one line naming the PNG it
skipped and carries on; every other error raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from vad_tpu_torch.eval.metrics import auroc, roc_points


class MatplotlibMissing(ImportError):
    """matplotlib cannot be imported, so no PNG can be drawn."""


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend; MatplotlibMissing when
    matplotlib does not import."""
    try:
        import matplotlib
    except ImportError as exc:
        raise MatplotlibMissing(f"matplotlib is not installed ({exc})") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_or_skip(plot_fn: Callable, *args, **kwargs) -> bool:
    """``plot_fn(*args, **kwargs)``, whose last positional argument is the
    PNG's path.  Returns False, after printing one line that names the PNG,
    when matplotlib cannot be imported; any other error raises."""
    try:
        plot_fn(*args, **kwargs)
    except MatplotlibMissing:
        print(f"Skipped {args[-1]}: matplotlib is not installed")
        return False
    return True


def denormalize(img: np.ndarray) -> np.ndarray:
    """[-1,1] HWC -> [0,1] for display."""
    return np.clip(np.asarray(img) * 0.5 + 0.5, 0.0, 1.0)


def _fs(v: Optional[int]) -> Dict:
    return {} if v is None else {"fontsize": v}


def plot_roc_curve(
    labels,
    scores,
    save_path: str | Path,
    *,
    title: str = "ROC Curve - Anomaly Detection",
    fontsize: Optional[Tuple[int, int, int]] = (12, 14, 11),
    diagonal_label: Optional[str] = "Random",
) -> None:
    """ROC artifact of the image and video evaluations.  The defaults are
    the image styling; the video evaluation passes its own title, no font
    sizes and no diagonal label."""
    plt = pyplot()
    fpr, tpr = roc_points(labels, scores)
    a = auroc(labels, scores)
    ax_fs, title_fs, leg_fs = fontsize if fontsize else (None, None, None)
    plt.figure(figsize=(8, 6))
    plt.plot(fpr, tpr, "b-", linewidth=2, label=f"AUROC = {a:.4f}")
    diag = {"label": diagonal_label} if diagonal_label else {}
    plt.plot([0, 1], [0, 1], "k--", linewidth=1, **diag)
    plt.xlabel("False Positive Rate", **_fs(ax_fs))
    plt.ylabel("True Positive Rate", **_fs(ax_fs))
    plt.title(title, **_fs(title_fs))
    plt.legend(loc="lower right", **_fs(leg_fs))
    plt.grid(True, alpha=0.3)
    plt.tight_layout()
    plt.savefig(save_path, dpi=150)
    plt.close()
    print(f"Saved ROC curve to {save_path}")


def plot_score_distribution(
    labels,
    scores,
    save_path: str | Path,
    *,
    xlabel: str = "Reconstruction Error (Anomaly Score)",
    title: str = "Score Distribution: Normal vs Anomaly",
    fontsize: Optional[Tuple[int, int, int]] = (12, 14, 11),
    count_in_label: bool = True,
    plot_empty_anomaly: bool = True,
) -> None:
    """Normal-vs-anomaly histogram of the image and video evaluations.  The
    video evaluation passes plain labels, its own title and x label, no
    font sizes, and skips the anomaly histogram when that class is absent."""
    plt = pyplot()
    labels = np.asarray(labels)
    scores = np.asarray(scores)
    normal = scores[labels == 0]
    anomaly = scores[labels == 1]
    ax_fs, title_fs, leg_fs = fontsize if fontsize else (None, None, None)

    def leg(name, arr):
        return f"{name} (n={len(arr)})" if count_in_label else name

    plt.figure(figsize=(10, 6))
    plt.hist(normal, bins=30, alpha=0.7, label=leg("Normal", normal), color="green")
    if plot_empty_anomaly or len(anomaly) > 0:
        plt.hist(anomaly, bins=30, alpha=0.7, label=leg("Anomaly", anomaly), color="red")
    plt.xlabel(xlabel, **_fs(ax_fs))
    plt.ylabel("Count", **_fs(ax_fs))
    plt.title(title, **_fs(title_fs))
    plt.legend(**_fs(leg_fs))
    plt.grid(True, alpha=0.3)
    plt.tight_layout()
    plt.savefig(save_path, dpi=150)
    plt.close()
    print(f"Saved score distribution to {save_path}")


def plot_reconstruction_grid(rows: Sequence[Dict], save_path: str | Path) -> None:
    """N x 4 grid: original | reconstruction | error map ('hot') | mask.

    Each row: {image, recon, error, mask, defect_type}, image/recon in
    [-1,1] HWC, error and mask [H,W].  No rows, no file."""
    n = len(rows)
    if n == 0:
        return
    plt = pyplot()
    fig, axes = plt.subplots(n, 4, figsize=(16, 4 * n))
    axes = np.atleast_2d(axes)
    for i, row in enumerate(rows):
        axes[i, 0].imshow(denormalize(row["image"]))
        axes[i, 0].set_title(f"Original ({row['defect_type']})", fontsize=10)
        axes[i, 0].axis("off")
        axes[i, 1].imshow(denormalize(row["recon"]))
        axes[i, 1].set_title("Reconstruction", fontsize=10)
        axes[i, 1].axis("off")
        im = axes[i, 2].imshow(row["error"], cmap="hot")
        axes[i, 2].set_title(f"Error Map (score: {float(np.mean(row['error'])):.4f})", fontsize=10)
        axes[i, 2].axis("off")
        fig.colorbar(im, ax=axes[i, 2], fraction=0.046)
        axes[i, 3].imshow(row["mask"], cmap="gray")
        axes[i, 3].set_title("Ground Truth", fontsize=10)
        axes[i, 3].axis("off")
    plt.tight_layout()
    plt.savefig(save_path, dpi=150)
    plt.close()
    print(f"Saved reconstructions to {save_path}")


def plot_training_history(history: Dict[str, list], save_path: str | Path) -> None:
    """Loss and separation curves over epochs."""
    plt = pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 5))
    epochs = np.arange(1, len(history.get("train_loss", [])) + 1)
    ax1.plot(epochs, history.get("train_loss", []), label="train loss")
    ax1.plot(epochs, history.get("val_loss", []), label="val loss")
    ax1.set_xlabel("epoch")
    ax1.set_ylabel("loss")
    ax1.legend()
    ax1.grid(True, alpha=0.3)
    sep = [
        (a / n if n > 0 else 0.0)
        for a, n in zip(history.get("anomaly_err", []), history.get("normal_err", []))
    ]
    ax2.plot(epochs, sep, color="purple", label="separation (anomaly/normal)")
    ax2.axhline(1.0, color="k", linestyle="--", linewidth=1)
    ax2.set_xlabel("epoch")
    ax2.set_ylabel("ratio")
    ax2.legend()
    ax2.grid(True, alpha=0.3)
    plt.tight_layout()
    plt.savefig(save_path, dpi=150)
    plt.close()


def plot_score_timeline(scores, save_path: str | Path, threshold: Optional[float] = None) -> None:
    """Per-frame scores of one video over time, with the calibrated
    threshold when there is one (``score_timeline.png`` and the batch
    scorer's ``<video>_timeline.png``)."""
    plt = pyplot()
    plt.figure(figsize=(12, 4))
    plt.plot(scores, "b-", linewidth=0.5)
    if threshold is not None:
        plt.axhline(threshold, color="r", linestyle="--", linewidth=0.8,
                    label=f"calibrated threshold {threshold:.6f}")
        plt.legend(loc="upper right")
    plt.xlabel("Frame")
    plt.ylabel("Anomaly Score")
    plt.title("Anomaly Score Timeline")
    plt.grid(True, alpha=0.3)
    plt.tight_layout()
    plt.savefig(save_path, dpi=150)
    plt.close()


def save_image_png(image: np.ndarray, save_path: str | Path) -> None:
    """An RGB uint8 image as a borderless figure (the evaluator's
    ``visualization_*.png``)."""
    plt = pyplot()
    plt.figure(figsize=(12, 4))
    plt.imshow(image)
    plt.axis("off")
    plt.tight_layout()
    plt.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close()
