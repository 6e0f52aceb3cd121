"""Multi-category campaigns (the JAX package's ``vad_tpu/campaign.py``):
train or evaluate every image category of a data root with one command,
and write the cross-category summary.

- ``--category all`` (or a comma list) on ``python -m vad_tpu_torch.train``
  runs the image trainer once per category, each run in its own
  ``<results-dir>/<category>_<timestamp>/``;
- a checkpoint directory on ``python -m vad_tpu_torch.evaluate`` evaluates
  each category's NEWEST best checkpoint under it with the per-category
  flow and writes ``summary.txt`` and ``summary.csv`` under
  ``<results-dir>/evaluation_all/``: image AUROC, AP, pixel AUROC and
  AUPRO per category and their unweighted mean (the MVTec convention).

A category that fails is reported and skipped; the others go on.
"""

from __future__ import annotations

import argparse
import copy
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence

_RUN_DIR_RE = r"\d{8}_\d{6}"  # image_trainer.py timestamp format


def discover_categories(data_dir: str | Path) -> List[str]:
    """Child directories of ``data_dir`` with a ``train/`` split — the
    image-dataset layout contract (reference dataset.py:54-61: any
    custom folder following the MVTec structure works)."""
    root = Path(data_dir)
    if not root.exists():
        return []
    return sorted(
        d.name for d in root.iterdir() if d.is_dir() and (d / "train").is_dir()
    )


def discover_trained_categories(results_dir: str | Path) -> List[str]:
    """Category names parsed from ``<category>_<timestamp>/best_model.ckpt``
    run dirs under ``results_dir``.  Used when --data-dir is omitted in an
    evaluation campaign: the set of categories that can actually be
    evaluated is the set with trained checkpoints, and each evaluate()
    then reads its data_dir from the checkpoint itself."""
    root = Path(results_dir)
    if not root.exists():
        return []
    pat = re.compile(r"(.+)_" + _RUN_DIR_RE + "$")
    cats = {
        m.group(1)
        for d in root.iterdir()
        if d.is_dir() and (m := pat.fullmatch(d.name)) and (d / "best_model.ckpt").exists()
    }
    # video runs land in video_<category>_<ts>/ (trainer parity with the
    # reference layout, main.py:57-75); they are not image campaigns.
    return sorted(c for c in cats if not c.startswith("video_"))


def categories_from_arg(category: Optional[str], data_dir: str | Path) -> List[str]:
    """Expand the --category value: 'all' discovers from the data dir, a
    comma list splits, a single name passes through as a one-element
    list.  Raises when 'all' finds nothing (a silent no-op campaign
    would read as success)."""
    if category and category != "all":
        return [c.strip() for c in category.split(",") if c.strip()]
    cats = discover_categories(data_dir)
    if not cats:
        raise FileNotFoundError(
            f"--category all: no category directories with a train/ split "
            f"under {data_dir}"
        )
    return cats


def checkpoint_for_category(
    results_dir: str | Path, category: str
) -> Optional[Path]:
    """Newest ``<category>_<timestamp>/best_model.ckpt`` under
    ``results_dir``.  The timestamp is matched structurally so a
    category whose name is a prefix of another's (``bottle`` vs
    ``bottle_cap``) never picks up the other's runs."""
    root = Path(results_dir)
    if not root.exists():
        return None
    pat = re.compile(re.escape(category) + "_" + _RUN_DIR_RE + "$")
    runs = sorted(
        (d for d in root.iterdir() if d.is_dir() and pat.fullmatch(d.name)),
        key=lambda d: d.name,
        reverse=True,
    )
    for run in runs:
        best = run / "best_model.ckpt"
        if best.exists():
            return best
    return None


def train_all(args: argparse.Namespace) -> Dict[str, Path]:
    """Run the image trainer once per category; returns
    {category: run_dir}.  A category that fails (e.g. an empty folder)
    is reported and skipped rather than aborting the remaining ones."""
    from vad_tpu_torch.train.image_trainer import train

    cats = categories_from_arg(args.category, args.data_dir)
    print(f"Training campaign over {len(cats)} categories: {', '.join(cats)}")
    runs: Dict[str, Path] = {}
    failures: List[str] = []
    for i, cat in enumerate(cats, 1):
        print(f"\n{'#' * 60}\n# [{i}/{len(cats)}] category: {cat}\n{'#' * 60}")
        cat_args = copy.copy(args)
        cat_args.category = cat
        try:
            runs[cat] = train(cat_args)["results_dir"]
        except Exception as e:  # noqa: BLE001 - campaign isolates failures
            print(f"Category {cat} FAILED: {type(e).__name__}: {e}")
            failures.append(cat)
    if failures:
        print(f"\nCampaign finished with failures: {', '.join(failures)}")
    return runs


_RESULT_LINE_RES = {
    "auroc": re.compile(r"^AUROC: ([0-9.]+)", re.M),
    "ap": re.compile(r"^Average precision \(AUPRC\): ([0-9.]+)", re.M),
    "pixel_auroc": re.compile(r"^Pixel-level AUROC: ([0-9.]+)", re.M),
    "aupro": re.compile(r"^AUPRO \(FPR<=0\.3\): ([0-9.]+)", re.M),
}


def _parse_results_txt(path: Path) -> Dict[str, float]:
    """Metric rows from a run's results.txt (our own test-pinned format;
    parsing it keeps evaluate()'s public float return unchanged)."""
    text = path.read_text() if path.exists() else ""
    out: Dict[str, float] = {}
    for key, rx in _RESULT_LINE_RES.items():
        m = rx.search(text)
        if m:
            out[key] = float(m.group(1))
    return out


def evaluate_all(args: argparse.Namespace) -> Dict[str, Dict[str, float]]:
    """Evaluate every category's newest checkpoint; returns
    {category: metrics} and writes the cross-category summary."""
    from vad_tpu_torch.eval.image_eval import evaluate

    results_dir = Path(getattr(args, "results_dir", None) or "./results")
    data_dir = getattr(args, "data_dir", None)
    category = getattr(args, "category", None)
    if data_dir is None and (not category or category == "all"):
        # No data root to scan: the evaluable set is the set with trained
        # checkpoints; each evaluate() reads data_dir from its checkpoint.
        cats = discover_trained_categories(results_dir)
        if not cats:
            raise FileNotFoundError(
                f"--category all with no --data-dir: no trained "
                f"<category>_<timestamp>/best_model.ckpt runs under "
                f"{results_dir}; pass --data-dir to discover categories "
                f"from a dataset root instead"
            )
    else:
        cats = categories_from_arg(category, data_dir or "./data")
    print(f"Evaluation campaign over {len(cats)} categories: {', '.join(cats)}")

    rows: Dict[str, Dict[str, float]] = {}
    missing: List[str] = []
    failed: List[str] = []
    for i, cat in enumerate(cats, 1):
        ckpt = checkpoint_for_category(results_dir, cat)
        if ckpt is None:
            print(f"[{i}/{len(cats)}] {cat}: no trained checkpoint under "
                  f"{results_dir} — skipped")
            missing.append(cat)
            continue
        print(f"\n{'#' * 60}\n# [{i}/{len(cats)}] category: {cat}\n"
              f"# checkpoint: {ckpt}\n{'#' * 60}")
        cat_args = copy.copy(args)
        cat_args.checkpoint = str(ckpt)
        cat_args.category = cat
        try:
            evaluate(cat_args)
        except Exception as e:  # noqa: BLE001 - campaign isolates failures
            print(f"Category {cat} evaluation FAILED: {type(e).__name__}: {e}")
            failed.append(cat)
            continue
        rows[cat] = _parse_results_txt(ckpt.parent / "evaluation" / "results.txt")

    if rows:
        out_dir = results_dir / "evaluation_all"
        write_summary(out_dir, rows, missing, failed)
        print(f"\nCampaign summary saved to: {out_dir}")
    if failed:
        print(f"Campaign finished with failures: {', '.join(failed)}")
    return rows


def write_summary(
    out_dir: Path,
    rows: Dict[str, Dict[str, float]],
    missing: Sequence[str] = (),
    failed: Sequence[str] = (),
) -> None:
    """summary.txt (human table) + summary.csv (machine rows), each with
    the unweighted category mean per metric — the MVTec reporting
    convention.  Absent metrics render '-' in the human table and an
    EMPTY cell in the CSV (naive float parsers choke on '-')."""
    out_dir.mkdir(parents=True, exist_ok=True)
    metrics = ["auroc", "ap", "pixel_auroc", "aupro"]
    headers = ["category", "AUROC", "AP", "pixel AUROC", "AUPRO"]

    def fmt(row: Dict[str, float], key: str) -> str:
        return f"{row[key]:.4f}" if key in row else "-"

    def fmt_csv(row: Dict[str, float], key: str) -> str:
        return f"{row[key]:.4f}" if key in row else ""

    means = {
        m: (sum(r[m] for r in rows.values() if m in r)
            / max(1, sum(1 for r in rows.values() if m in r)))
        for m in metrics
        if any(m in r for r in rows.values())
    }

    with open(out_dir / "summary.csv", "w") as f:
        f.write(",".join(["category"] + metrics) + "\n")
        for cat in sorted(rows):
            f.write(",".join([cat] + [fmt_csv(rows[cat], m) for m in metrics]) + "\n")
        f.write(",".join(["mean"] + [fmt_csv(means, m) for m in metrics]) + "\n")

    widths = [max(len(h), 14) for h in headers]
    with open(out_dir / "summary.txt", "w") as f:
        f.write("Multi-category evaluation summary\n")
        f.write("=" * 50 + "\n\n")
        f.write("  ".join(h.ljust(w) for h, w in zip(headers, widths)) + "\n")
        f.write("  ".join("-" * w for w in widths) + "\n")
        for cat in sorted(rows):
            cells = [cat] + [fmt(rows[cat], m) for m in metrics]
            f.write("  ".join(c.ljust(w) for c, w in zip(cells, widths)) + "\n")
        cells = ["mean"] + [fmt(means, m) for m in metrics]
        f.write("  ".join(c.ljust(w) for c, w in zip(cells, widths)) + "\n")
        if missing:
            f.write(f"\nSkipped (no checkpoint): {', '.join(missing)}\n")
        if failed:
            f.write(f"Failed (evaluation error): {', '.join(failed)}\n")
