"""Ablation of the fused first block (kernel 4) by stage: kernel 6.

The counterpart of the JAX package's ``tools/ablate_block1.py``.  Kernel 6
runs kernel 4 with one stage stripped (``ops/encoder_fused.py`` gives each
mode's function), on kernel 4's grid, at the JAX tool's shape: F=256
frames of 256x256, bf16 out, folded weights from a seed.  The time a mode
saves against ``full`` is what its stripped stage costs:

- ``dma-only``: staging the window and storing, no MMAs, no epilogue;
- ``no-dot``: without the conv's tensor-core MMAs;
- ``no-band``: without the out-of-frame test and pad value;
- ``no-epilogue``: without the max-pool and LeakyReLU;
- ``full``: kernel 4.

One JSON line per mode: ``ms`` (CUDA events, warmed up) and
``us_per_frame`` as the JAX tool prints them, ``bound_ms`` (every mode
reads the frames and weights and writes the output once, so the bytes
bound is the same for all), the plain version's ``plain_ms`` and the
kernel's ``max_abs_err`` against it.  ``--device cpu`` runs the plain
versions (host clock; no bound) at a size given by ``--frames``/``--image``.

Usage:
    python -m vad_tpu_torch.tools.ablate_block1
    python -m vad_tpu_torch.tools.ablate_block1 --device cpu --frames 2 --image 32
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional, Sequence, Tuple

import torch

from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.ops.encoder_fused import (
    ABLATION_MODES, first_block_ablate, first_block_ablate_ref, fold_first_block,
)
from vad_tpu_torch.utils.profiling import device_peaks, time_ms

SEED = 0
_CONV_MODES = ("full", "no-epilogue", "no-band")  # modes that keep the conv's MMAs


def block_weights(gen: torch.Generator, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random first block (conv, bias, inference BatchNorm) folded into
    the kernel's ``[32,3,3,3]`` weight and ``[32]`` bias."""
    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    kernel, bias = rnd(32, 3, 3, 3, scale=0.2), rnd(32, scale=0.1)
    mean = rnd(32, scale=0.05)
    var = torch.rand(32, generator=gen, device=device) * 1.5 + 0.5
    return fold_first_block(kernel, bias, mean, var, rnd(32), rnd(32, scale=0.1))


def block_cost(frames: int, height: int, width: int, out_bytes: int,
               mode: str = "full") -> Tuple[int, int]:
    """(FLOP, bytes) of the first block at one mode: the frames and the
    folded weights read once, the pooled output written once; the conv's
    multiply-adds where the mode keeps them."""
    flops = 2 * frames * height * width * 32 * 27 if mode in _CONV_MODES else 0
    nbytes = (frames * height * width * 3 + frames * (height // 2) * (width // 2) * 32 * out_bytes
              + (864 + 32) * 4)
    return flops, nbytes


def ablate(u8: torch.Tensor, w: torch.Tensor, b: torch.Tensor, mode: str,
           out_dtype=torch.bfloat16) -> dict:
    """One mode of kernel 6 on ``u8 [F,H,W,3]``: timed, bounded and held
    against its plain version."""
    device = u8.device
    f, h, wid, _ = u8.shape
    err = float((first_block_ablate(u8, w, b, mode, out_dtype).float()
                 - first_block_ablate_ref(u8, w, b, mode, out_dtype).float()).abs().max())
    ms = time_ms(lambda: first_block_ablate(u8, w, b, mode, out_dtype), device)
    rec = {"probe": "ablate_block1", "mode": mode, "shape": list(u8.shape),
           "out_dtype": str(out_dtype).removeprefix("torch."),
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "ms": ms, "us_per_frame": ms / f * 1e3,
           "plain_ms": time_ms(lambda: first_block_ablate_ref(u8, w, b, mode, out_dtype), device,
                               iters=3, warmup=1),
           "bound_ms": None, "bound_by": None, "max_abs_err": err}
    if device.type == "cuda":
        _, peak_flops, _, peak_bw = device_peaks(rec["device"])
        flops, nbytes = block_cost(f, h, wid, torch.empty((), dtype=out_dtype).element_size(),
                                   mode)
        t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
        rec.update(bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops > t_bytes else "bytes")
    return rec


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Ablation of the fused first-block kernel")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the kernels, timed on the card) or cpu (the plain versions)")
    parser.add_argument("--frames", type=int, default=256, help="Frames per chunk")
    parser.add_argument("--image", type=int, default=256, help="Frame size")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    u8 = torch.randint(0, 256, (args.frames, args.image, args.image, 3), generator=gen,
                       device=device, dtype=torch.uint8)
    w, b = block_weights(gen, device)
    records = []
    with torch.no_grad():
        for mode in ABLATION_MODES:
            records.append(ablate(u8, w, b, mode))
            print(json.dumps(records[-1]), flush=True)
    return records


if __name__ == "__main__":
    main()
