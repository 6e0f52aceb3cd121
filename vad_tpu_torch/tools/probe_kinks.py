"""Probe of the image model's f32 train step against float64: why two f32
steps of it may part by far more than their rounding.

The step is ``multiprocess_check``'s data-parallel form: the image model
(latent 32) at 16x16 on its first global batch of 16 noise images.  It is
piecewise linear: every BatchNorm output feeds a (leaky) ReLU or a 2x2
max-pool, so an element that f32 rounding puts on the other side of a
kink moves every gradient upstream of it.  For the step at 16 rows and at
its first 8 (as one process runs it, TF32 off; on a card with cuDNN's
convolutions and then with the native ones), against the same step in
float64 on the CPU, it prints one JSON line per case with:

- ``grad_rel_l2``: each parameter's gradient against float64's (median,
  max; the biases that feed a BatchNorm left out: their exact gradient is
  0);
- ``kinks``: per BatchNorm, the elements whose sign differs from
  float64's, the smallest float64 magnitude and the largest f32 error;

and on the CPU a last line ``one_kink``: how far (rel L2, median and max)
negating the decoder's smallest last-norm output in float64 moves the
gradients, the size of one flipped kink.

Usage:
    python -m vad_tpu_torch.tools.probe_kinks [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.parallel.multiprocess_check import (
    BATCH_SIZE,
    SEED,
    _model_and_data,
    zero_gradient_biases,
)


def _batch() -> torch.Tensor:
    from vad_tpu_torch.data.loader import DistributedLoader

    _, dataset = _model_and_data(1)
    loader = DistributedLoader(dataset, BATCH_SIZE, shuffle=True, seed=SEED, num_workers=0,
                               device="cpu")
    return torch.as_tensor(next(iter(loader))[0]["image"])


def train_step(u8: torch.Tensor, device: torch.device, dtype: Optional[torch.dtype] = None,
               negate: Sequence[int] = ()) -> tuple:
    """One step's gradients (float64, CPU, by name) and every BatchNorm's
    output (float64, CPU, by module name) of the check's image model on
    ``u8``; ``negate``: flat indices of the decoder's last norm output to
    negate (a flipped kink)."""
    from vad_tpu_torch.models.norms import BatchNorm
    from vad_tpu_torch.ops.losses import mse_per_sample
    from vad_tpu_torch.train.steps import make_train_step
    from vad_tpu_torch.utils.precision import tf32_off

    model, _ = _model_and_data(1)
    model = model.to(device)
    outs: Dict[str, torch.Tensor] = {}

    def keep(name):
        def hook(module, args, out):
            if name == "decoder.norm" and negate:
                out = out.clone()
                flat = out.view(-1)
                flat[list(negate)] = -flat[list(negate)]
            outs[name] = out.detach().double().cpu()
            return out
        return hook

    for name, module in model.named_modules():
        if isinstance(module, BatchNorm):
            module.register_forward_hook(keep(name))
    optimizer = torch.optim.SGD(model.parameters(), lr=0.0)  # keeps the weights, leaves .grad
    with tf32_off(device.type == "cuda"):
        make_train_step(mse_per_sample, dtype)(model, optimizer, u8.to(device), u8.shape[0])
    return {n: p.grad.double().cpu() for n, p in model.named_parameters()}, outs


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _spread(values) -> dict:
    return {"median": float(np.median(values)), "max": float(np.max(values))}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    u8 = _batch()
    skip = set(zero_gradient_biases(_model_and_data(1)[0]))
    for cudnn in ((True, False) if device.type == "cuda" else (True,)):
        for rows in (BATCH_SIZE, BATCH_SIZE // 2):
            g64, y64 = train_step(u8[:rows], torch.device("cpu"), torch.float64)
            torch.backends.cudnn.enabled = cudnn
            try:
                g32, y32 = train_step(u8[:rows], device)
            finally:
                torch.backends.cudnn.enabled = True
            kinks = {name: {"flipped": int(((y32[name] > 0) != (y64[name] > 0)).sum()),
                            "smallest_abs_f64": float(y64[name].abs().min()),
                            "largest_f32_err": float((y32[name] - y64[name]).abs().max())}
                     for name in y64}
            print(json.dumps({
                "device": str(device), "cudnn": cudnn, "rows": rows,
                "grad_rel_l2": _spread([_rel_l2(g32[n], g64[n]) for n in g64 if n not in skip]),
                "kinks_flipped": sum(k["flipped"] for k in kinks.values()), "kinks": kinks,
            }), flush=True)
    if device.type == "cpu":
        g64, y64 = train_step(u8, device, torch.float64)
        smallest = int(y64["decoder.norm"].abs().flatten().argmin())
        flipped, _ = train_step(u8, device, torch.float64, negate=[smallest])
        print(json.dumps({"one_kink": _spread([_rel_l2(flipped[n], g64[n])
                                               for n in g64 if n not in skip])}), flush=True)


if __name__ == "__main__":
    main()
