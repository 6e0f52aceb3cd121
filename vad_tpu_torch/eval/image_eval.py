"""Image-model evaluation (the JAX package's ``vad_tpu/eval/image_eval.py``):
image AUROC and average precision, the per-defect breakdown, pixel AUROC
and AUPRO against the ground-truth masks, ``roc_curve.png``,
``score_distribution.png``, ``reconstructions.png`` and ``results.txt`` in
the JAX evaluator's format, under ``<checkpoint dir>/evaluation/``.

The anomaly map is the reconstruction error (``--scorer recon``) or the
latent distance upsampled to the image (``--scorer latent``,
``eval/latent_score.py``), optionally blurred (``--score-smooth``) and
reduced to the image score by its mean, max or 99th percentile
(``--score-mode``).  Images stay uint8 to the device and are normalized
there; on the card everything runs in f32 with TF32 off, so scores hold
the f32 bar.  One pass over the test split gives both the image scores and
the maps the pixel metrics read (the JAX evaluator makes two).

Where the JAX functions take ``(model, variables, ...)``, these take the
model, which holds its weights; ``maps_fn(model, scorer_state, x)`` is the
JAX ``maps_fn(variables, scorer_state, x)``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vad_tpu_torch.core.config import ImageAEConfig
from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.data.image_dataset import MVTecDataset
from vad_tpu_torch.data.loader import DistributedLoader
from vad_tpu_torch.eval.metrics import aupro, auroc, average_precision, per_defect_breakdown
from vad_tpu_torch.eval.plots import (
    plot_or_skip,
    plot_reconstruction_grid,
    plot_roc_curve,
    plot_score_distribution,
)
from vad_tpu_torch.models.autoencoder import ConvAutoencoder
from vad_tpu_torch.ops.losses import _gaussian_window
from vad_tpu_torch.train.steps import u8_normalize
from vad_tpu_torch.utils.checkpoint import load_checkpoint
from vad_tpu_torch.utils.precision import tf32_off
from vad_tpu_torch.utils.weights import load_flax_variables

SCORE_MODES = ("mean", "max", "p99")
MapsFn = Callable[[ConvAutoencoder, Any, torch.Tensor], torch.Tensor]

# Options of the JAX evaluator whose modules the port does not have yet.
_NOT_PORTED = (("data_parallel", "--data-parallel", "Queue 1 item 10 (scaling)"),)


def refuse_unported(args: Any) -> None:
    """Raise for an option whose module the port does not have yet."""
    for attr, flag, item in _NOT_PORTED:
        if getattr(args, attr, None):
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP {item})")


def load_image_model(checkpoint_path: str | Path, device=None
                     ) -> Tuple[ConvAutoencoder, Dict, Dict]:
    """(model in eval mode on ``device``, its JAX-layout variables, the
    checkpoint's ``args``) from an image ``.ckpt`` of either package.
    ``device`` ``None`` means CUDA."""
    ckpt = load_checkpoint(checkpoint_path)
    train_args = ckpt.get("args", {})
    model = ConvAutoencoder.from_config(ImageAEConfig.from_args(train_args), device=device)
    variables = {"params": ckpt["params"], "batch_stats": ckpt.get("batch_stats") or {}}
    load_flax_variables(model, variables).eval()
    print(f"Loaded model from epoch {ckpt.get('epoch', 'unknown')}")
    if ckpt.get("train_loss") is not None:
        print(f"Training loss: {ckpt['train_loss']:.6f}")
    return model, variables, train_args


def smooth_error_map(err: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur of maps ``[B,H,W]`` (window ``max(3, 2·round(2σ)+1)``
    pixels, zero padding at the edges: JAX's "SAME" convolution), so a
    max or percentile score answers defect-sized blobs, not hot pixels."""
    size = max(3, int(2 * round(2 * sigma) + 1))
    win = torch.as_tensor(_gaussian_window(size, sigma), dtype=err.dtype, device=err.device)
    return F.conv2d(err[:, None], win[None, None], padding=size // 2)[:, 0]


def reduce_maps(err: torch.Tensor, score_mode: str = "mean") -> torch.Tensor:
    """Maps ``[B,H,W]`` -> image scores ``[B]``: their mean (the reference
    score), max, or 99th percentile (linear interpolation, as
    ``jnp.percentile``)."""
    if score_mode not in SCORE_MODES:
        raise ValueError(f"score_mode must be one of {SCORE_MODES}, got {score_mode!r}")
    flat = err.reshape(err.shape[0], -1)
    if score_mode == "max":
        return flat.max(dim=1).values
    if score_mode == "p99":
        return torch.quantile(flat, 0.99, dim=1)
    return flat.mean(dim=1)


def anomaly_maps(model: ConvAutoencoder, x: torch.Tensor, score_smooth: float = 0.0,
                 maps_fn: Optional[MapsFn] = None, scorer_state=None) -> torch.Tensor:
    """Anomaly maps ``[B,H,W]`` of normalized images ``x``: the latent
    distance (``maps_fn``) or the reconstruction error, then the blur."""
    with torch.no_grad():
        err = (maps_fn(model, scorer_state, x) if maps_fn is not None
               else model.reconstruction_error(x, per_pixel=True))
        return smooth_error_map(err, score_smooth) if score_smooth > 0 else err


def score_split(model: ConvAutoencoder, test_ds, batch_size: int = 16, num_workers: int = 4,
                score_mode: str = "mean", score_smooth: float = 0.0,
                maps_fn: Optional[MapsFn] = None, scorer_state=None,
                keep_maps: bool = False) -> Dict[str, Any]:
    """One pass over ``test_ds`` (uint8 images) on the model's device, in
    eval mode: ``labels`` [N], ``scores`` [N] (float64), ``defects``, and
    with ``keep_maps`` the maps [N,H,W] and the masks (> 0.5) on the host."""
    device = model.device
    loader = DistributedLoader(test_ds, batch_size, num_workers=num_workers, device=device)
    out = {"labels": [], "scores": [], "defects": [], "maps": [], "masks": []}
    model.eval()
    with tf32_off(device.type == "cuda"):
        for batch, n_real in loader:
            err = anomaly_maps(model, u8_normalize(batch["image"]), score_smooth, maps_fn,
                               scorer_state)
            out["scores"].append(reduce_maps(err, score_mode)[:n_real].cpu().numpy())
            out["labels"].append(np.asarray(batch["label"])[:n_real])
            out["defects"].extend(batch["defect_type"][:n_real])
            if keep_maps:
                out["maps"].append(err[:n_real].cpu().numpy())
                out["masks"].append(np.asarray(batch["mask"])[:n_real] > 0.5)
    res = {"labels": np.concatenate(out["labels"]).astype(np.int64),
           "scores": np.concatenate(out["scores"]).astype(np.float64),
           "defects": out["defects"]}
    if keep_maps:
        res["maps"], res["masks"] = np.concatenate(out["maps"]), np.concatenate(out["masks"])
    return res


def compute_scores(model: ConvAutoencoder, test_ds, batch_size: int = 16,
                   num_workers: int = 4, score_mode: str = "mean", score_smooth: float = 0.0,
                   maps_fn: Optional[MapsFn] = None, scorer_state=None):
    """(labels, scores, defect_types) over the test split."""
    r = score_split(model, test_ds, batch_size, num_workers, score_mode, score_smooth,
                    maps_fn, scorer_state)
    return r["labels"], r["scores"], r["defects"]


def localization(maps: np.ndarray, masks: np.ndarray) -> Dict[str, float]:
    """Pixel AUROC of maps against binary masks over the whole split, and
    AUPRO to FPR 0.3; NaN where the masks cannot support the metric."""
    flat = masks.astype(np.int64).reshape(-1)
    pixel = float("nan") if flat.min() == flat.max() else auroc(flat, maps.reshape(-1))
    return {"pixel_auroc": pixel, "aupro": aupro(masks, maps)}


def compute_localization(model: ConvAutoencoder, test_ds, batch_size: int = 16,
                         score_smooth: float = 0.0, maps_fn: Optional[MapsFn] = None,
                         scorer_state=None) -> Dict[str, float]:
    """``pixel_auroc`` and ``aupro`` of the split's anomaly maps (blurred as
    the image score's are) against the ground-truth masks."""
    r = score_split(model, test_ds, batch_size, score_smooth=score_smooth, maps_fn=maps_fn,
                    scorer_state=scorer_state, keep_maps=True)
    return localization(r["maps"], r["masks"])


def make_reconstruction_rows(model: ConvAutoencoder, test_ds, n_samples: int = 8,
                             maps_fn: Optional[MapsFn] = None, scorer_state=None):
    """Half normal, half anomalous samples with the reconstruction, the
    anomaly map and the mask, for ``reconstructions.png``; the image in
    [-1, 1] whatever ``test_ds`` returns."""
    labels = test_ds.labels
    selected = ([i for i, lab in enumerate(labels) if lab == 0][: n_samples // 2]
                + [i for i, lab in enumerate(labels) if lab == 1][: n_samples // 2])
    device = model.device
    model.eval()
    rows = []
    for idx in selected:
        sample = test_ds[idx]
        image = torch.as_tensor(sample["image"][None], device=device)
        x = u8_normalize(image) if image.dtype == torch.uint8 else image.float()
        with torch.no_grad(), tf32_off(device.type == "cuda"):
            recon = model(x)
            err = anomaly_maps(model, x, maps_fn=maps_fn, scorer_state=scorer_state)
        rows.append({"image": x[0].cpu().numpy(), "recon": recon[0].cpu().numpy(),
                     "error": err[0].cpu().numpy(), "mask": sample["mask"],
                     "defect_type": sample["defect_type"]})
    return rows


def make_latent_maps_fn(model: ConvAutoencoder, train_ds, *, batch_size: int = 16,
                        layers=(0, 1, 2), proj_dim: int = 128, grid=None, seed: int = 0,
                        save_path=None, load_path=None):
    """Fit (one encoder pass over ``train_ds``, uint8 images) or load the
    latent scorer; returns ``(maps_fn, scorer_state)`` with
    ``maps_fn(model, state, x) -> [B,H,W]`` Mahalanobis maps upsampled to
    the image size."""
    from vad_tpu_torch.eval.latent_score import (
        fit_or_load,
        make_distance_fn,
        stats_state,
        upsample_maps,
    )

    def pyramid_fn(m, x):
        return m.feature_pyramid(x)

    device = model.device
    model.eval()
    loader = DistributedLoader(train_ds, batch_size, num_workers=4, device=device)
    with tf32_off(device.type == "cuda"):
        batches = (u8_normalize(b["image"][:n]) for b, n in loader)  # no padded tail rows
        stats = fit_or_load(pyramid_fn, model, batches,
                            layers=layers, proj_dim=proj_dim, grid=grid, seed=seed,
                            save_path=save_path, load_path=load_path, what="images")
    dfn = make_distance_fn(pyramid_fn, stats.layers, stats.grid)

    def maps_fn(m, state, x):
        return upsample_maps(dfn(m, state, x), x.shape[1])

    return maps_fn, stats_state(stats, device)


def write_results_txt(path: Path, score: float, breakdown: Dict[str, Dict],
                      pixel_score: float = float("nan"), aupro_score: float = float("nan"),
                      scorer: str = "recon", ap_score: float = float("nan")) -> None:
    """The JAX evaluator's ``results.txt``, byte for byte: the reference's
    lines, then average precision, the localization metrics and a
    non-default scorer where they apply."""
    with open(path, "w") as f:
        f.write(f"AUROC: {score:.4f}\n\n")
        f.write("Per-defect breakdown:\n")
        for defect, res in sorted(breakdown.items()):
            status = "ANOMALY" if res["is_anomaly"] else "NORMAL"
            f.write(f"  {defect}: {status}, n={res['count']}, "
                    f"mean_score={res['mean_score']:.4f}\n")
        if np.isfinite(ap_score):
            f.write(f"\nAverage precision (AUPRC): {ap_score:.4f}\n")
        if np.isfinite(pixel_score):
            f.write(f"\nPixel-level AUROC: {pixel_score:.4f}\n")
        if np.isfinite(aupro_score):
            f.write(f"AUPRO (FPR<=0.3): {aupro_score:.4f}\n")
        if scorer != "recon":
            f.write(f"\nScorer: {scorer}\n")


def evaluate(args: Any) -> float:
    """Evaluate ``args.checkpoint`` on its category's test split; writes
    ``<checkpoint dir>/evaluation/`` and returns the image AUROC (0.0 when
    the split has one class)."""
    refuse_unported(args)
    device = resolve_device(getattr(args, "device", None))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"Using device: {device.type}:{name}")

    checkpoint_path = Path(args.checkpoint)
    model, _, train_args = load_image_model(checkpoint_path, device)
    category = args.category or train_args.get("category", "synthetic")
    data_dir = args.data_dir or train_args.get("data_dir", "./data")
    image_size = int(train_args.get("image_size", 256))

    print(f"\nEvaluating on category: {category}")
    test_ds = MVTecDataset(data_dir, category, "test", image_size, normalize=False)
    print(f"Test samples: {len(test_ds)}")
    output_dir = checkpoint_path.parent / "evaluation"
    output_dir.mkdir(exist_ok=True)

    score_mode = getattr(args, "score_mode", "mean") or "mean"
    score_smooth = float(getattr(args, "score_smooth", 0.0) or 0.0)
    if score_mode != "mean" or score_smooth > 0:
        print(f"Score mode: {score_mode} of the per-pixel error map"
              + (f" (gaussian sigma={score_smooth})" if score_smooth > 0 else ""))

    maps_fn = scorer_state = None
    scorer = getattr(args, "scorer", "recon") or "recon"
    if scorer == "latent":
        train_ds = MVTecDataset(data_dir, category, "train", image_size, normalize=False)
        load_path = getattr(args, "latent_stats", None)
        if not load_path:
            print(f"Latent-distance scorer: fitting per-position Gaussians on "
                  f"{len(train_ds)} normal training images...")
        else:
            print("Latent-distance scorer:")
        maps_fn, scorer_state = make_latent_maps_fn(
            model, train_ds, proj_dim=int(getattr(args, "latent_proj_dim", 128) or 128),
            grid=getattr(args, "latent_grid", None), seed=int(getattr(args, "seed", 0) or 0),
            save_path=output_dir / "latent_stats.npz", load_path=load_path)

    print("\nComputing metrics...")
    split = score_split(model, test_ds, score_mode=score_mode, score_smooth=score_smooth,
                        maps_fn=maps_fn, scorer_state=scorer_state, keep_maps=True)
    labels, scores, defects = split["labels"], split["scores"], split["defects"]
    ap_score = float("nan")
    if len(np.unique(labels)) > 1:
        score = auroc(labels, scores)
        ap_score = average_precision(labels, scores)
    else:
        score = 0.0
        print("Cannot compute AUROC - only one class present")
    breakdown = per_defect_breakdown(labels, scores, defects)
    loc = localization(split["maps"], split["masks"])
    pixel_score = loc["pixel_auroc"]

    print(f"\n{'=' * 50}")
    print(f"AUROC: {score:.4f}")
    if np.isfinite(ap_score):
        print(f"Average precision (AUPRC): {ap_score:.4f}")
    if np.isfinite(pixel_score):
        print(f"Pixel-level AUROC: {pixel_score:.4f}")
    if np.isfinite(loc["aupro"]):
        print(f"AUPRO (FPR<=0.3): {loc['aupro']:.4f}")
    print(f"{'=' * 50}")
    print("\nPer-defect-type breakdown:")
    print("-" * 40)
    for defect, res in sorted(breakdown.items()):
        status = "ANOMALY" if res["is_anomaly"] else "NORMAL"
        print(f"  {defect:20s} | {status:7s} | n={res['count']:3d} | "
              f"mean_score={res['mean_score']:.4f}")

    print("\nGenerating visualizations...")
    if len(np.unique(labels)) > 1:
        plot_or_skip(plot_roc_curve, labels, scores, output_dir / "roc_curve.png")
    plot_or_skip(plot_score_distribution, labels, scores, output_dir / "score_distribution.png")
    rows = make_reconstruction_rows(model, test_ds, maps_fn=maps_fn, scorer_state=scorer_state)
    plot_or_skip(plot_reconstruction_grid, rows, output_dir / "reconstructions.png")
    write_results_txt(output_dir / "results.txt", score, breakdown, pixel_score, loc["aupro"],
                      scorer=scorer, ap_score=ap_score)
    print(f"\nResults saved to: {output_dir}")
    return score
