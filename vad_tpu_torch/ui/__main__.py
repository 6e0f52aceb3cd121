"""Web UI of the PyTorch port (``python -m vad_tpu_torch.ui``; the JAX
package's ``main.py``).

Serves the six-tab gradio app on 0.0.0.0:7860 with the models on
``--device`` (default ``cuda``).  gradio is optional: without it this
prints the CLI equivalents and exits with code 1.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Anomaly detection web UI (PyTorch port)")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", type=str, default="cuda",
                   help="Device the models run on: cuda (the card, the kernels) or cpu")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    print("=" * 60)
    print("ANOMALY DETECTION SYSTEM (PyTorch)")
    print("=" * 60)
    try:
        import gradio  # noqa: F401
    except ImportError:
        print("\nThe web UI requires gradio, which is not installed in this environment.\n"
              "Install it with `pip install gradio`, or use the CLI equivalents:\n"
              "  python -m vad_tpu_torch.train --category <cat>           # train image model\n"
              "  python -m vad_tpu_torch.train_video --category <cat>     # train video model\n"
              "  python -m vad_tpu_torch.evaluate --checkpoint <ckpt>     # image AUROC + plots\n"
              "  python -m vad_tpu_torch.evaluate_video --checkpoint <c>  # video AUROC / mp4\n"
              "  python -m vad_tpu_torch.data.synthetic --data-dir ./data # sample image data")
        return 1
    from vad_tpu_torch.ui.app import launch

    print("\nStarting application...")
    print(f"Open: http://localhost:{args.port}")
    print("Press Ctrl+C to stop")
    print("=" * 60)
    launch(host=args.host, port=args.port, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
