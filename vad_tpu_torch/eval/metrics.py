"""Host-side metrics: AUROC, average precision, ROC points, AUPRO,
thresholds, separation and the per-defect breakdown (a copy of the JAX
package's numpy-only ``vad_tpu/eval/metrics.py``).

Scores come back from the device once per evaluation; the metric
arithmetic is small and stays on the host.  scikit-learn is used where it
imports, with numpy fallbacks that give the same numbers, so the port has
no hard dependency on it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

try:
    from sklearn.metrics import average_precision_score as _sk_ap
    from sklearn.metrics import roc_auc_score as _sk_auroc
    from sklearn.metrics import roc_curve as _sk_roc_curve
except ImportError:  # pragma: no cover - the card's machine may lack it
    _sk_ap = None
    _sk_auroc = None
    _sk_roc_curve = None


def auroc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve: 1.0 perfect, 0.5 chance."""
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    if _sk_auroc is not None:
        return float(_sk_auroc(labels, scores))
    # Mann-Whitney U with midranks for ties
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        raise ValueError("AUROC needs both classes present")
    allv = np.concatenate([pos, neg])
    order = np.argsort(allv)
    sorted_v = allv[order]
    rank_vals = np.empty_like(sorted_v)
    i = 0
    while i < len(sorted_v):
        j = i
        while j + 1 < len(sorted_v) and sorted_v[j + 1] == sorted_v[i]:
            j += 1
        rank_vals[i : j + 1] = 0.5 * (i + j) + 1.0
        i = j + 1
    ranks = np.empty_like(rank_vals)
    ranks[order] = rank_vals
    r_pos = ranks[: len(pos)].sum()
    u = r_pos - len(pos) * (len(pos) + 1) / 2.0
    return float(u / (len(pos) * len(neg)))


def average_precision(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the precision-recall curve as the step sum
    Σ_n (R_n − R_{n−1})·P_n over descending-score thresholds, ties grouped
    into one threshold (scikit-learn's definition; no interpolation)."""
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    if labels.sum() == 0 or labels.sum() == len(labels):
        raise ValueError("average precision needs both classes present")
    if _sk_ap is not None:
        return float(_sk_ap(labels, scores))
    order = np.argsort(-scores, kind="stable")
    sorted_labels = (labels[order] == 1).astype(np.float64)
    sorted_scores = scores[order]
    tps = np.cumsum(sorted_labels)
    fps = np.cumsum(1.0 - sorted_labels)
    # one (P, R) point per distinct threshold: the last index of each
    # tied-score run
    run_ends = np.nonzero(np.diff(sorted_scores))[0]
    idx = np.concatenate([run_ends, [len(sorted_scores) - 1]])
    precision = tps[idx] / (tps[idx] + fps[idx])
    recall = tps[idx] / tps[-1]
    d_recall = np.diff(np.concatenate([[0.0], recall]))
    return float(np.sum(d_recall * precision))


def roc_points(labels: np.ndarray, scores: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(fpr, tpr) arrays for plotting, one point per distinct threshold."""
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    if _sk_roc_curve is not None:
        fpr, tpr, _ = _sk_roc_curve(labels, scores)
        return fpr, tpr
    order = np.argsort(-scores)
    labels = labels[order]
    sorted_scores = scores[order]
    tps = np.cumsum(labels == 1)
    fps = np.cumsum(labels == 0)
    run_ends = np.nonzero(np.diff(sorted_scores))[0]
    idx = np.concatenate([run_ends, [len(sorted_scores) - 1]])
    tpr = np.concatenate([[0.0], tps[idx] / max(tps[-1], 1)])
    fpr = np.concatenate([[0.0], fps[idx] / max(fps[-1], 1)])
    return fpr, tpr


def _label_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """4-connected component labelling: scipy where it imports, else BFS."""
    try:
        from scipy.ndimage import label as _sp_label

        lab, k = _sp_label(mask)
        return lab, int(k)
    except ImportError:  # pragma: no cover
        h, w = mask.shape
        lab = np.zeros((h, w), np.int32)
        k = 0
        for i in range(h):
            for j in range(w):
                if mask[i, j] and not lab[i, j]:
                    k += 1
                    stack = [(i, j)]
                    lab[i, j] = k
                    while stack:
                        a, b = stack.pop()
                        for x, y in ((a + 1, b), (a - 1, b), (a, b + 1), (a, b - 1)):
                            if 0 <= x < h and 0 <= y < w and mask[x, y] and not lab[x, y]:
                                lab[x, y] = k
                                stack.append((x, y))
        return lab, k


def aupro(
    masks: np.ndarray,
    error_maps: np.ndarray,
    fpr_limit: float = 0.3,
    num_thresholds: int = 256,
) -> float:
    """Area under the Per-Region-Overlap curve up to ``fpr_limit``, divided
    by ``fpr_limit`` (MVTec-AD's localization metric): per threshold, the
    mean over connected ground-truth regions of |region ∩ prediction| /
    |region|, traced against the false-positive rate on normal pixels.
    Thresholds are normal-score quantiles, sampling the FPR uniformly on
    [0, fpr_limit].  NaN when there is no defect region or no normal pixel.
    """
    masks = np.asarray(masks) > 0.5
    maps = np.asarray(error_maps, np.float64)
    if masks.shape != maps.shape:
        raise ValueError(f"masks {masks.shape} vs error maps {maps.shape}")

    comp_scores = []
    for m, e in zip(masks, maps):
        if not m.any():
            continue
        lab, k = _label_components(m)
        for c in range(1, k + 1):
            comp_scores.append(np.sort(e[lab == c]))
    normal_scores = np.sort(maps[~masks])
    if not comp_scores or normal_scores.size == 0:
        return float("nan")

    n_norm = normal_scores.size
    qs = np.linspace(1.0, 1.0 - fpr_limit, num_thresholds)
    thresholds = np.quantile(normal_scores, qs)
    fprs = 1.0 - np.searchsorted(normal_scores, thresholds, side="left") / n_norm
    pros = np.zeros(len(thresholds))
    for cs in comp_scores:
        pros += 1.0 - np.searchsorted(cs, thresholds, side="left") / cs.size
    pros /= len(comp_scores)

    order = np.argsort(fprs)
    fprs, pros = fprs[order], pros[order]
    # anchor at FPR=0 with the PRO of a threshold above every normal pixel,
    # and clip the tail at fpr_limit by interpolation
    top = normal_scores[-1]
    pro0 = sum(
        1.0 - np.searchsorted(cs, top, side="right") / cs.size
        for cs in comp_scores
    ) / len(comp_scores)
    fprs = np.concatenate([[0.0], fprs])
    pros = np.concatenate([[pro0], pros])
    keep = fprs <= fpr_limit
    f_kept, p_kept = fprs[keep], pros[keep]
    if f_kept[-1] < fpr_limit and keep.sum() < len(fprs):
        p_edge = np.interp(fpr_limit, fprs, pros)
        f_kept = np.concatenate([f_kept, [fpr_limit]])
        p_kept = np.concatenate([p_kept, [p_edge]])
    return float(np.trapezoid(p_kept, f_kept) / fpr_limit)


def calibrate_threshold(normal_scores: Sequence[float], quantile: float = 0.99) -> float | None:
    """Anomaly-decision threshold from held-out NORMAL scores only: their
    ``quantile`` (p99: ~1% false positives on normal data, whatever the
    model, category or loss scale).  None when there are no normal scores."""
    s = np.asarray(list(normal_scores), np.float64)
    if s.size == 0:
        return None
    return float(np.quantile(s, quantile))


def serving_frame_threshold(ckpt: dict) -> float | None:
    """The calibrated threshold valid for PER-FRAME reconstruction scores
    (batch video scoring, serving): the checkpoint's
    ``frame_score_threshold``, and only when it was trained to reconstruct
    (a predict-calibrated threshold is on another score scale than the
    reconstruction error the streaming step emits)."""
    obj = (ckpt.get("args") or {}).get("objective", "reconstruct") or "reconstruct"
    if obj != "reconstruct":
        return None
    return ckpt.get("frame_score_threshold")


def serving_score_baseline(ckpt: dict) -> dict | None:
    """The checkpoint's training-time score distribution, gated like
    ``serving_frame_threshold`` (image checkpoints always pass)."""
    obj = (ckpt.get("args") or {}).get("objective", "reconstruct") or "reconstruct"
    if ckpt.get("model_type") != "image" and obj != "reconstruct":
        return None
    return ckpt.get("score_baseline")


def separation_ratio(normal_scores: Sequence[float], anomaly_scores: Sequence[float]) -> float:
    """mean(anomaly) / mean(normal), the model-selection metric; 0.0 when
    either side is empty or the normal mean is not positive."""
    normal_scores = np.asarray(list(normal_scores))
    anomaly_scores = np.asarray(list(anomaly_scores))
    if len(normal_scores) == 0 or normal_scores.mean() <= 0:
        return 0.0
    if len(anomaly_scores) == 0:
        return 0.0
    return float(anomaly_scores.mean() / normal_scores.mean())


def per_defect_breakdown(
    labels: np.ndarray, scores: np.ndarray, defect_types: List[str]
) -> Dict[str, Dict]:
    """{defect: {count, mean_score, is_anomaly}}, defects in sorted order."""
    labels = np.asarray(labels)
    scores = np.asarray(scores)
    out: Dict[str, Dict] = {}
    for defect in sorted(set(defect_types)):
        mask = np.array([d == defect for d in defect_types])
        out[defect] = {
            "count": int(mask.sum()),
            "mean_score": float(scores[mask].mean()),
            "is_anomaly": int(labels[mask][0]) if mask.any() else 0,
        }
    return out
