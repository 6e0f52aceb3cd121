"""UI logic of the PyTorch port, separate from the gradio widgets (the JAX
package's ``vad_tpu/ui/logic.py``).

Plain Python, testable without gradio.  As in the JAX package:

- checkpoint discovery scans ``<results>/*/best_model.ckpt``, classifying
  video models by the ``video_`` run-dir prefix;
- category discovery scans data dirs for MVTec-style ``train/`` folders
  and IPAD-style ``training/frames`` trees;
- image analysis uses the fixed threshold 0.004 (or the checkpoint's
  calibrated one) and confidence ``min(|score-threshold|/threshold*100,
  100)``;
- video analysis scores every frame once through the port's
  ``stream_scores`` (kernel 1 on the card) and thresholds at mean + 2*std.

Models load onto ``AppState(device=...)`` (``None`` means CUDA).  The
report strings are the JAX package's except the backend line.  Where
matplotlib does not import, the heatmap and the timeline are None and the
reports are still returned.  The training and evaluation commands run the
port's CLIs (``python -m vad_tpu_torch.<cli>``).
"""

from __future__ import annotations

import io
import subprocess
import sys
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.eval.plots import MatplotlibMissing, pyplot
from vad_tpu_torch.utils.checkpoint import load_checkpoint
from vad_tpu_torch.utils.precision import tf32_off

IMAGE_THRESHOLD = 0.004


# ---------------------------------------------------------------- discovery

def discover_checkpoints(model_type: str = "image", results_dir: str = "./results") -> List[str]:
    """best_model.ckpt paths, newest run first, filtered by model type."""
    root = Path(results_dir)
    if not root.exists():
        return []
    out = []
    for folder in sorted(root.iterdir(), reverse=True):
        if not folder.is_dir():
            continue
        best = folder / "best_model.ckpt"
        if not best.exists():
            continue
        is_video = "video_" in folder.name
        if (model_type == "all" or (model_type == "video" and is_video)
                or (model_type == "image" and not is_video)):
            out.append(str(best))
    return out


def discover_image_categories(data_dirs: Tuple[str, ...] = ("./data", "./data/original")
                              ) -> List[str]:
    cats: List[str] = []
    for d in data_dirs:
        root = Path(d)
        if not root.exists():
            continue
        for folder in sorted(root.iterdir()):
            if folder.is_dir() and (folder / "train").exists() and folder.name not in cats:
                cats.append(folder.name)
    return cats or ["No datasets found - see Help tab"]


def discover_video_categories(ipad_dir: str = "./data/IPAD", data_dir: str = "./data"
                              ) -> List[str]:
    cats: List[str] = []
    ipad = Path(ipad_dir)
    if ipad.exists():
        for folder in sorted(ipad.iterdir()):
            if folder.is_dir() and (folder / "training" / "frames").exists():
                cats.append(folder.name)
    root = Path(data_dir)
    if root.exists():
        for folder in sorted(root.iterdir()):
            if not folder.is_dir() or folder.name in ("IPAD", "original"):
                continue
            if (folder / "training" / "frames").exists():
                if folder.name not in cats:
                    cats.append(folder.name)
                continue
            train = folder / "train"
            if not train.exists():
                continue
            for sub in train.iterdir():
                if not sub.is_dir():
                    continue
                has_videos = any(f.suffix in (".mp4", ".avi", ".mov")
                                 for f in sub.iterdir() if f.is_file())
                has_frames = any(f.is_dir() for f in sub.iterdir())
                if has_videos or has_frames:
                    if folder.name not in cats:
                        cats.append(folder.name)
                    break
    return cats or ["No video datasets found - see Help tab"]


def find_data_dir_for_category(category: str, video: bool = False) -> Optional[str]:
    """Which data root holds the category."""
    if video:
        if (Path("./data/IPAD") / category / "training" / "frames").exists():
            return "./data/IPAD"
        if (Path("./data") / category / "training" / "frames").exists():
            return "./data"
        if (Path("./data") / category / "train").exists():
            return "./data"
        return None
    for root in ("./data", "./data/original"):
        if (Path(root) / category / "train").exists():
            return root
    return None


# ---------------------------------------------------------------- app state

def backend_line(device: torch.device) -> str:
    """The reports' backend: PyTorch with the device's name."""
    if device.type == "cuda":
        return f"PyTorch/CUDA ({torch.cuda.get_device_name(device)})"
    return f"PyTorch/{device.type.upper()}"


class AppState:
    """Loaded models and their metadata across UI interactions; models load
    onto ``device`` (``None`` means CUDA)."""

    def __init__(self, device=None) -> None:
        self.device = resolve_device(device)
        self.model = None
        self.variables = None
        self.model_args: dict = {}
        self.video_model = None
        self.video_variables = None
        self.video_args: dict = {}
        # calibrated thresholds from the checkpoints when present (p99 of
        # validation normal scores); None falls back to the fixed
        # IMAGE_THRESHOLD / mean+2*std
        self.score_threshold = None
        self.video_score_threshold = None

    def load_image_model(self, checkpoint_path: str) -> str:
        if not checkpoint_path or not Path(checkpoint_path).exists():
            return "Error: Checkpoint file not found."
        try:
            from vad_tpu_torch.eval.image_eval import load_image_model

            self.model, self.variables, self.model_args = load_image_model(
                checkpoint_path, device=self.device)
            ckpt = load_checkpoint(checkpoint_path)
            self.score_threshold = ckpt.get("score_threshold")
            thr_line = (
                f"- Calibrated threshold: {self.score_threshold:.6f} "
                f"({ckpt.get('threshold_method', 'calibrated')})\n"
                if self.score_threshold is not None else "")
            return ("Model loaded successfully.\n\n"
                    f"Details:\n"
                    f"- Epoch: {ckpt.get('epoch', 'unknown')}\n"
                    f"- Training Loss: {ckpt.get('train_loss', 0) or 0:.6f}\n"
                    f"- Category: {self.model_args.get('category', 'unknown')}\n"
                    f"{thr_line}"
                    f"- Backend: {backend_line(self.device)}")
        except Exception as e:  # noqa: BLE001 - shown in the UI
            return f"Error loading model: {e}"

    def load_video_model(self, checkpoint_path: str) -> str:
        if not checkpoint_path or not Path(checkpoint_path).exists():
            return "Error: Checkpoint file not found."
        try:
            from vad_tpu_torch.eval.video_eval import load_video_model

            self.video_model, self.video_variables, self.video_args = load_video_model(
                checkpoint_path, device=self.device)
            ckpt = load_checkpoint(checkpoint_path)
            # the video analysis scores PER FRAME, so the frame-granularity
            # threshold is the comparable one
            self.video_score_threshold = ckpt.get("frame_score_threshold")
            return ("Video model loaded successfully.\n\n"
                    f"Details:\n"
                    f"- Epoch: {ckpt.get('epoch', 'unknown')}\n"
                    f"- Separation Ratio: {ckpt.get('separation', 0) or 0:.2f}x\n"
                    f"- Category: {self.video_args.get('category', 'unknown')}\n"
                    f"- Sequence Length: {self.video_args.get('sequence_length', 16)} frames\n"
                    f"- Backend: {backend_line(self.device)}")
        except Exception as e:  # noqa: BLE001
            return f"Error loading video model: {e}"


# ---------------------------------------------------------------- analysis

def image_report(score: float, threshold: float = IMAGE_THRESHOLD) -> str:
    is_anomaly = score > threshold
    status = "ANOMALY DETECTED" if is_anomaly else "NORMAL"
    confidence = min(abs(score - threshold) / threshold * 100, 100)
    return (
        f"ANALYSIS COMPLETE\n{'=' * 60}\n\n"
        f"Status: {status}\n"
        f"Anomaly Score: {score:.6f}\n"
        f"Threshold: {threshold:.6f}\n"
        f"Confidence: {confidence:.1f}%\n\n"
        f"{'=' * 60}\nINTERPRETATION\n\n"
        + ("WARNING: Anomaly detected." if is_anomaly else "Image appears normal.")
    )


def score_image(state: AppState, image_array: np.ndarray, image_size: int = 256):
    """(recon uint8 HWC, error map [H, W], score) of an uploaded image,
    resized bilinearly to the model's size; one forward on the model's
    device (f32, TF32 off), the score as ``reconstruction_error`` takes it."""
    from PIL import Image

    img = Image.fromarray(np.asarray(image_array)).convert("RGB")
    size = int(state.model_args.get("image_size", image_size))
    img = img.resize((size, size), Image.BILINEAR)
    x = torch.from_numpy(np.asarray(img, np.float32)[None] / 127.5 - 1.0).to(state.device)
    with torch.no_grad(), tf32_off(state.device.type == "cuda"):
        recon = state.model(x)
        err = torch.mean(torch.square(x - recon), dim=-1)
        score = torch.mean(err, dim=(1, 2))
    recon_u8 = (np.clip(recon[0].cpu().numpy() * 0.5 + 0.5, 0, 1) * 255).astype(np.uint8)
    return recon_u8, err[0].cpu().numpy(), float(score[0])


def analyze_image(state: AppState, image_array: np.ndarray, image_size: int = 256):
    """(recon uint8 HWC, heatmap PIL or None, report str) for an uploaded image."""
    if state.model is None:
        return None, None, "Please load a model first."
    if image_array is None:
        return None, None, "Please upload an image to analyze."
    recon_u8, err_map, score = score_image(state, image_array, image_size)
    threshold = state.score_threshold if state.score_threshold is not None else IMAGE_THRESHOLD
    return recon_u8, _heatmap_image(err_map), image_report(score, threshold)


def _figure_image(fig, plt, **savefig):
    from PIL import Image

    buf = io.BytesIO()
    plt.savefig(buf, format="png", **savefig)
    buf.seek(0)
    plt.close(fig)
    return Image.open(buf)


def _heatmap_image(error_map: np.ndarray):
    """The error map as a PIL heatmap; None where matplotlib does not import."""
    try:
        plt = pyplot()
    except MatplotlibMissing:
        return None
    fig, ax = plt.subplots(figsize=(4, 4))
    im = ax.imshow(error_map, cmap="hot")
    ax.axis("off")
    plt.colorbar(im, ax=ax, fraction=0.046)
    plt.tight_layout()
    return _figure_image(fig, plt, dpi=100, bbox_inches="tight")


def _timeline_image(scores: np.ndarray):
    """The score timeline as a PIL image; None where matplotlib does not import."""
    try:
        plt = pyplot()
    except MatplotlibMissing:
        return None
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.plot(scores, "b-", linewidth=1)
    ax.axhline(y=float(np.mean(scores) + 2 * np.std(scores)), color="r", linestyle="--",
               label="Threshold")
    ax.set_xlabel("Frame")
    ax.set_ylabel("Anomaly Score")
    ax.set_title("Video Anomaly Score Timeline")
    ax.legend()
    ax.grid(True, alpha=0.3)
    plt.tight_layout()
    return _figure_image(fig, plt, dpi=150)


def video_report(scores: np.ndarray, calibrated: float | None = None) -> str:
    """The reference's report (mean+2*std self-threshold), plus the
    checkpoint's calibrated threshold where it carries one."""
    mean = float(np.mean(scores))
    mx = float(np.max(scores))
    threshold = mean + 2 * float(np.std(scores))
    anomaly_frames = np.where(scores > threshold)[0]
    calib_lines = ""
    if calibrated is not None:
        n_cal = int(np.sum(scores > calibrated))
        calib_lines = (
            f"- Calibrated Threshold (p99 normal): {calibrated:.6f}\n"
            f"- Frames Above Calibrated Threshold: {n_cal} "
            f"({100 * n_cal / max(len(scores), 1):.1f}%)\n")
    text = (
        f"VIDEO ANALYSIS COMPLETE\n{'=' * 60}\n\n"
        f"Video Statistics:\n"
        f"- Total Frames Analyzed: {len(scores)}\n"
        f"- Mean Anomaly Score: {mean:.6f}\n"
        f"- Max Anomaly Score: {mx:.6f}\n"
        f"- Threshold (mean + 2*std): {threshold:.6f}\n"
        f"{calib_lines}\n"
        f"Anomaly Detection:\n"
        f"- Frames Above Threshold: {len(anomaly_frames)}\n"
        f"- Anomaly Percentage: {100 * len(anomaly_frames) / max(len(scores), 1):.1f}%\n\n"
        f"{'=' * 60}\n")
    if len(anomaly_frames) > 0:
        text += f"\nPotential anomaly frames: {anomaly_frames[:20].tolist()}"
        if len(anomaly_frames) > 20:
            text += f"\n... and {len(anomaly_frames) - 20} more"
    else:
        text += "\nNo significant anomalies detected."
    return text


def video_scores(state: AppState, video_path: str) -> np.ndarray:
    """Per-frame scores of a video file through the port's
    ``stream_scores`` (the model's chunk length, its objective)."""
    from vad_tpu_torch.eval.video_render import stream_scores

    return stream_scores(
        state.video_model, None, video_path, int(state.video_args.get("image_size", 256)),
        chunk=int(state.video_args.get("sequence_length", 16)),
        objective=state.video_args.get("objective", "reconstruct") or "reconstruct")


def analyze_video(state: AppState, video_path: str):
    """(timeline PIL or None, report) for an uploaded video, scored per frame."""
    if state.video_model is None:
        return None, "Please load a video model first."
    if video_path is None:
        return None, "Please upload a video file."
    try:
        scores = video_scores(state, video_path)
        if len(scores) == 0:
            return None, "Video too short for analysis."
        return _timeline_image(scores), video_report(
            np.asarray(scores), calibrated=state.video_score_threshold)
    except Exception as e:  # noqa: BLE001 - shown in the UI
        return None, f"Error analyzing video: {e}"


# ---------------------------------------------------------------- training

def build_train_command(category: str, epochs: int, batch_size: int, lr: float, loss: str,
                        data_dir: str, device: str = "cuda") -> List[str]:
    return [sys.executable, "-m", "vad_tpu_torch.train",
            "--category", category,
            "--data-dir", data_dir,
            "--epochs", str(int(epochs)),
            "--batch-size", str(int(batch_size)),
            "--lr", str(lr),
            "--loss", loss,
            "--device", device]


def build_video_train_command(category: str, epochs: int, batch_size: int, lr: float,
                              data_dir: str, device: str = "cuda") -> List[str]:
    return [sys.executable, "-m", "vad_tpu_torch.train_video",
            "--category", category,
            "--data-dir", data_dir,
            "--epochs", str(int(epochs)),
            "--batch-size", str(int(batch_size)),
            "--lr", str(lr),
            "--device", device]


def stream_subprocess(cmd: List[str], header: str, tail: int = 40) -> Iterator[str]:
    """Run a CLI, yielding header + the rolling last ``tail`` output lines."""
    yield header + "Initializing...\n"
    try:
        process = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True, bufsize=1)
        lines: List[str] = []
        for line in process.stdout:
            line = line.strip()
            if line:
                lines.append(line)
                yield header + "\n".join(lines[-tail:])
        process.wait()
        yield header + "\n".join(lines[-tail:]) + "\n\nCOMPLETE"
    except Exception as e:  # noqa: BLE001 - shown in the UI
        yield f"Error: {e}"


def load_results_artifacts(checkpoint_path: str):
    """(roc, dist, recon, results_text) from ``<run>/evaluation/``."""
    from PIL import Image

    if not checkpoint_path:
        return None, None, None, "Please select a checkpoint first."
    eval_dir = Path(checkpoint_path).parent / "evaluation"
    if not eval_dir.exists():
        return None, None, None, "No evaluation results found. Run evaluation first."

    def img(name):
        p = eval_dir / name
        return Image.open(p) if p.exists() else None

    recon = img("reconstructions.png")
    if recon is None:
        vis = sorted(eval_dir.glob("visualization_*.png"))
        recon = Image.open(vis[0]) if vis else None
    results_path = eval_dir / "results.txt"
    text = results_path.read_text() if results_path.exists() else "No results.txt found."
    return img("roc_curve.png"), img("score_distribution.png"), recon, text


def build_eval_command(checkpoint_path: str, device: str = "cuda") -> Optional[List[str]]:
    """The port's image or video evaluator by run-dir prefix, with the data
    dir from the checkpoint's args."""
    is_video = "video_" in Path(checkpoint_path).parent.name
    ckpt = load_checkpoint(checkpoint_path)
    category = ckpt.get("args", {}).get("category", "synthetic")
    stored_dir = ckpt.get("args", {}).get("data_dir")
    data_dir = (stored_dir if stored_dir and Path(stored_dir, category).exists()
                else find_data_dir_for_category(category, video=is_video))
    if data_dir is None:
        return None
    module = "vad_tpu_torch.evaluate_video" if is_video else "vad_tpu_torch.evaluate"
    return [sys.executable, "-m", module,
            "--checkpoint", checkpoint_path,
            "--data-dir", data_dir,
            "--category", category,
            "--device", device]
