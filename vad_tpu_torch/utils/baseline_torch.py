"""Torch-CPU baseline for the bench's ``vs_baseline`` ratio (the JAX
package's ``vad_tpu/utils/baseline_torch.py``).

The reference publishes no throughput numbers, so the baseline is
measured: a torch model with the reference's exact architecture (per-frame
conv encoder, 2-layer ConvLSTM with a fused 4-gate conv per step,
per-frame transposed-conv decoder), scoring non-overlapping 16-frame
windows on the host CPU, forward only.  This is the reference's *best
case* (its own --video mode re-scores every frame sequence_length times),
so vs_baseline is conservative.

The measurement is cached in ``vad_tpu_torch/build/baseline_measured.json``
(built at run time, never committed), under the JAX package's key, with
the CPU's model name and torch's thread count beside it: a host's figure
names its host.
"""

from __future__ import annotations

import json
import os
import platform
import time
from pathlib import Path

CACHE = Path(__file__).resolve().parents[1] / "build" / "baseline_measured.json"


def host_cpu() -> str:
    """The host CPU as ``/proc/cpuinfo`` names it (its model name, else its
    vendor, family and model), else as ``platform`` does, with the count of
    CPUs this process sees."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if value.strip() not in ("", "unknown"):  # a virtualized host may not know
                    fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = fields.get("model name") or " ".join(
        f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model") if fields.get(k))
    if not name:
        name = next((n for n in (platform.processor(), platform.machine())
                     if n and n != "unknown"), "unknown")
    return f"{name}, {len(os.sched_getaffinity(0))} CPUs"


def _build_reference_equivalent_model():
    import torch
    import torch.nn as nn

    class Cell(nn.Module):
        def __init__(self, cin, ch):
            super().__init__()
            self.ch = ch
            self.conv = nn.Conv2d(cin + ch, 4 * ch, 3, padding=1)

        def forward(self, x, h, c):
            gates = self.conv(torch.cat([x, h], dim=1))
            i, f, g, o = torch.split(gates, self.ch, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            return h, c

    class RefVideoAE(nn.Module):
        def __init__(self, latent=128, hidden=128, layers=2):
            super().__init__()
            enc = []
            cin = 3
            for cout in (32, 64, 128, latent):
                enc += [
                    nn.Conv2d(cin, cout, 3, padding=1),
                    nn.BatchNorm2d(cout),
                    nn.LeakyReLU(0.2, inplace=True),
                    nn.MaxPool2d(2, 2),
                ]
                cin = cout
            self.encoder = nn.Sequential(*enc)
            self.cells = nn.ModuleList(
                [Cell(latent if i == 0 else hidden, hidden) for i in range(layers)]
            )
            dec = []
            cin = hidden
            for cout in (128, 64, 32):
                dec += [
                    nn.ConvTranspose2d(cin, cout, 2, stride=2),
                    nn.BatchNorm2d(cout),
                    nn.ReLU(inplace=True),
                ]
                cin = cout
            dec += [nn.ConvTranspose2d(cin, 3, 2, stride=2), nn.Tanh()]
            self.decoder = nn.Sequential(*dec)
            self.hidden = hidden

        def forward(self, x):  # [B, T, C, H, W]
            b, t, c, h, w = x.shape
            z = self.encoder(x.reshape(b * t, c, h, w))
            zc, zh, zw = z.shape[1:]
            z = z.reshape(b, t, zc, zh, zw)
            cur = z
            for cell in self.cells:
                hs = torch.zeros(b, self.hidden, zh, zw)
                cs = torch.zeros(b, self.hidden, zh, zw)
                outs = []
                for ti in range(t):
                    hs, cs = cell(cur[:, ti], hs, cs)
                    outs.append(hs)
                cur = torch.stack(outs, dim=1)
            y = self.decoder(cur.reshape(b * t, self.hidden, zh, zw))
            return y.reshape(b, t, 3, h, w)

    return RefVideoAE()


def _key(image_size: int, sequence_length: int) -> str:
    return f"torch_cpu_fps_{image_size}_{sequence_length}"


def cached_host(image_size: int = 256, sequence_length: int = 16, cache: Path = CACHE) -> dict:
    """``{"cpu", "threads"}`` of the host that measured the cached figure
    (empty when there is none)."""
    if not cache.exists():
        return {}
    return json.loads(cache.read_text()).get("hosts", {}).get(_key(image_size, sequence_length),
                                                              {})


def measure_reference_cpu_fps(
    image_size: int = 256,
    sequence_length: int = 16,
    n_windows: int = 10,
    force: bool = False,
    cache: Path = CACHE,
) -> float:
    """Frames/sec of the reference-equivalent torch model on CPU (cached).

    Reports the BEST of ``n_windows`` single-window timings (the
    reference's most favourable steady state) so the cached denominator
    is not a thin average over a cold run."""
    key = _key(image_size, sequence_length)
    if cache.exists() and not force:
        data = json.loads(cache.read_text())
        if key in data:
            return float(data[key])

    import torch

    torch.set_num_threads(max(torch.get_num_threads(), 1))
    model = _build_reference_equivalent_model().eval()
    x = torch.randn(1, sequence_length, 3, image_size, image_size)
    best = float("inf")
    with torch.no_grad():
        model(x)  # warm-up
        for _ in range(n_windows):
            t0 = time.perf_counter()
            model(x)
            best = min(best, time.perf_counter() - t0)
    fps = sequence_length / best

    data = json.loads(cache.read_text()) if cache.exists() else {}
    data[key] = fps
    data.setdefault("hosts", {})[key] = {"cpu": host_cpu(), "threads": torch.get_num_threads()}
    data["note"] = (
        "reference-equivalent torch model, CPU forward-only, non-overlapping "
        "windows (reference best case; its --video mode rescored every frame "
        "sequence_length times)"
    )
    cache.parent.mkdir(parents=True, exist_ok=True)
    cache.write_text(json.dumps(data, indent=2) + "\n")
    return fps


if __name__ == "__main__":
    print(measure_reference_cpu_fps(force=True))
