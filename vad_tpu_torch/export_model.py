"""Export a trained checkpoint as a ``torch.export`` serving artifact with
the PyTorch port.

The flags of the JAX package's ``export_model.py``, plus ``--device``
(default ``cuda``; ``cpu`` exports and checks on the CPU).  The artifact is
``torch.export.save``'s ``.pt2`` with the weights baked in and a JSON
sidecar (``<output>.json``) holding the calling convention; on the card
its recurrence is kernel 1 (``vad_tpu_torch/utils/export.py``).  Load it
with ``vad_tpu_torch.utils.export.load_artifact``, which registers the
port's operators first.

    python -m vad_tpu_torch.export_model --checkpoint results/.../best_model.ckpt \\
        --output artifacts/scorer.pt2 --platforms cuda,cpu

Image checkpoints export a batch-polymorphic uint8 scorer by default (any
request size); video checkpoints export the state-carrying multi-stream
step at a fixed (slots, chunk).
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Export a checkpoint as a torch.export serving artifact (PyTorch port)")
    p.add_argument("--checkpoint", type=str, required=True,
                   help="Trained checkpoint (image or video; either package's, or "
                        "torch-imported)")
    p.add_argument("--output", type=str, required=True,
                   help="Artifact path (a .json sidecar with the calling "
                        "convention is written next to it)")
    p.add_argument("--batch", type=int, default=None,
                   help="Pin the image batch size (default: symbolic — one "
                        "artifact serves any batch)")
    p.add_argument("--slots", type=int, default=16, help="Stream slots for video exports")
    p.add_argument("--chunk", type=int, default=16,
                   help="Frames per step per stream for video exports")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"],
                   help="Compute precision baked into the artifact")
    p.add_argument("--platforms", type=str, default=None,
                   help="Comma-separated devices the artifact is called on before it "
                        "is written, 'cuda' (or 'gpu') and 'cpu' (default: --device)")
    p.add_argument("--device", type=str, default="cuda",
                   help="Device to export on: cuda (the card, kernel 1) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    from vad_tpu_torch.utils.export import export_from_checkpoint

    platforms = ([s.strip() for s in args.platforms.split(",") if s.strip()]
                 if args.platforms else None)
    path = export_from_checkpoint(
        args.checkpoint, args.output, batch=args.batch, num_slots=args.slots,
        chunk=args.chunk, dtype=args.dtype, platforms=platforms, device=args.device,
    )
    sidecar = json.loads((path.parent / (path.name + ".json")).read_text())
    print(f"Exported {args.checkpoint}")
    print(f"  -> {path} ({sidecar['bytes']:,} bytes, platforms {sidecar['platforms']})")
    print(f"  in:  {sidecar['in_avals']}")
    print(f"  out: {sidecar['out_avals']}")


if __name__ == "__main__":
    main()
