"""Plain PyTorch reference of MemAE, the memory-augmented 3D-convolutional
video autoencoder.

Gong et al., "Memorizing Normality to Detect Anomaly", ICCV 2019
(arXiv:1904.02639), as github.com/donggong1/memae-anomaly-detection builds
it (``models/memae_3dconv.py`` ``AutoEncoderCov3DMem``;
``models/memory_module.py`` ``MemoryUnit``, ``MemModule``,
``hard_shrink_relu``):

- encoder: 4 x (conv3d 3x3x3, padding 1 + BatchNorm + LeakyReLU 0.2),
  widths in -> w0 (stride (1, 2, 2)) -> w1 -> w2 -> w3 (stride 2);
- memory M ``[mem_dim, w3]``: each position's query z (a w3-vector) reads
  w = softmax(z M^T) over the items, hard-shrunk at lambda as
  relu(w - lambda) w / (|w - lambda| + 1e-12), L1-normalised as
  w / max(|w|_1, 1e-12), then z_hat = w M;
- decoder: conv_transpose3d 3x3x3, padding 1, w3 -> w2 -> w1 -> w0
  (stride 2, output padding 1), each with BatchNorm + LeakyReLU, then
  w0 -> in (stride (1, 2, 2), output padding (0, 1, 1)), no activation;
- the score of a frame: the mean of (x - recon)^2 over its pixels.

Written from those equations with ``torch.nn.functional`` alone, in
float32 with TF32 off; it imports nothing of the program.  Weights are a
flat dict under the official module names (``layout``).  Departures from
the official code:

- the input is the RGB uint8 a camera stream sends, turned gray here
  (BT.601: 0.299 R + 0.587 G + 0.114 B of u8 / 127.5 - 1); the official
  loader reads gray frames normalised with mean 0.5, std 0.5, the same
  [-1, 1];
- the score is each frame's raw reconstruction error: the official test
  script's min-max normalisation over a whole test video needs the video's
  end, which a live stream does not have;
- BatchNorm in inference only (running statistics, eps 1e-5): the
  training loss (the read's entropy, weight 0.0002) is not here;
- clips run in blocks (``BLOCK``) so that a chunk of them fits in
  float32 beside the program.

``Numerics`` names the arithmetic: ``f32`` is the reference itself;
``fp8``, the scoring cell's control, is the reference one precision lower
than the cell states put in the program's place: e4m3 operands of every
3-D convolution, scaled per tensor, and bfloat16 results
(``reference/video_ae.py``'s emulation, taken from there), and the memory's
addressing and read in bfloat16.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _sibling(name: str):
    """Another reference of this folder, loaded by path (a reference
    imports nothing of the benchmark's package)."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_reference_{name}", Path(__file__).with_name(f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_video_ae = _sibling("video_ae")
exact_f32 = _video_ae.exact_f32

BN_EPS = 1e-5
SLOPE = 0.2
SHRINK_EPS = 1e-12
GRAY = (0.299, 0.587, 0.114)
MEMORY = "mem_rep.memory.weight"
BLOCK = 4  # clips a block
# the sizes a CPU test run of this model uses (``benchmark/tests/cases.py``)
TINY = {"image_size": 32, "sequence_length": 8, "widths": [8, 8, 16, 16], "mem_dim": 64}

Weights = Dict[str, torch.Tensor]


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every weight's name and shape (the official state dict's, without
    BatchNorm's batch counters): conv3d kernels ``[out, in, 3, 3, 3]``,
    conv_transpose3d kernels ``[in, out, 3, 3, 3]``, M ``[mem_dim, w3]``."""
    widths, cin = list(cfg["widths"]), cfg["in_channels"]
    out = []

    def layer(prefix, kernel, co, norm):
        out.extend([(f"{prefix}.{kernel[0]}.weight", kernel[1]), (f"{prefix}.{kernel[0]}.bias",
                                                                  (co,))])
        if norm:
            out.extend((f"{prefix}.{kernel[0] + 1}.{k}", (co,))
                       for k in ("weight", "bias", "running_mean", "running_var"))

    for i, (ci, co) in enumerate(zip([cin, *widths[:-1]], widths)):
        layer("encoder", (3 * i, (co, ci, 3, 3, 3)), co, True)
    out.append((MEMORY, (cfg["mem_dim"], widths[-1])))
    for i, (ci, co) in enumerate(zip(widths[::-1], [*widths[-2::-1], cin])):
        layer("decoder", (3 * i, (ci, co, 3, 3, 3)), co, i < len(widths) - 1)
    return out


class Numerics(_video_ae.Numerics):
    """The arithmetic of the convolutions and of the memory (module
    docstring)."""

    KINDS = ("f32", "fp8")

    @property
    def addressing(self) -> torch.dtype:
        return torch.bfloat16 if self.kind == "fp8" else torch.float32

    def conv3d(self, x, w, b, stride):
        y = F.conv3d(self.operand(x), self.operand(w), None, stride=stride, padding=1)
        return self.result(y + b.view(-1, 1, 1, 1))

    def deconv3d(self, x, w, b, stride, output_padding):
        y = F.conv_transpose3d(self.operand(x), self.operand(w), None, stride=stride, padding=1,
                               output_padding=output_padding)
        return self.result(y + b.view(-1, 1, 1, 1))


def gray(u8: torch.Tensor) -> torch.Tensor:
    """RGB uint8 ``[B, T, H, W, 3]`` -> float32 clips ``[B, 1, T, H, W]``."""
    x = u8.float().div(127.5).sub(1.0)
    y = GRAY[0] * x[..., 0] + GRAY[1] * x[..., 1] + GRAY[2] * x[..., 2]
    return y[:, None]


def batch_norm(y: torch.Tensor, w: Weights, prefix: str) -> torch.Tensor:
    """Inference BatchNorm on the running statistics, over ``[B, C, ...]``."""
    mean, var = w[f"{prefix}.running_mean"], w[f"{prefix}.running_var"]
    scale = torch.rsqrt(var + BN_EPS) * w[f"{prefix}.weight"]
    view = (-1, 1, 1, 1)
    return (y - mean.view(view)) * scale.view(view) + w[f"{prefix}.bias"].view(view)


def encode(x: torch.Tensor, w: Weights, num: Numerics) -> torch.Tensor:
    """Clips ``[B, in, T, H, W]`` -> z ``[B, w3, T/8, H/16, W/16]``."""
    y = x
    for i in range(4):
        k = 3 * i
        y = num.conv3d(y, w[f"encoder.{k}.weight"], w[f"encoder.{k}.bias"],
                       (1, 2, 2) if i == 0 else 2)
        y = F.leaky_relu(batch_norm(y, w, f"encoder.{k + 1}"), SLOPE)
    return y


def queries(z: torch.Tensor) -> torch.Tensor:
    """z ``[B, C, t, h, w]`` -> one query a position ``[B*t*h*w, C]``."""
    return z.movedim(1, -1).reshape(-1, z.shape[1])


def address(q: torch.Tensor, w: Weights, shrink: float, num: Numerics) -> torch.Tensor:
    """Queries ``[N, C]`` -> the read's weights ``[N, mem_dim]`` in the
    addressing type."""
    m = w[MEMORY].to(num.addressing)
    att = F.softmax(q.to(num.addressing) @ m.t(), dim=1)
    if shrink > 0:
        att = F.relu(att - shrink) * att / (torch.abs(att - shrink) + SHRINK_EPS)
        att = att / att.abs().sum(dim=1, keepdim=True).clamp_min(SHRINK_EPS)
    return att


def read(att: torch.Tensor, w: Weights, num: Numerics) -> torch.Tensor:
    return att @ w[MEMORY].to(num.addressing)


def memory(z: torch.Tensor, w: Weights, shrink: float, num: Numerics) -> torch.Tensor:
    """z ``[B, C, t, h, w]`` -> z_hat of the same shape, float32."""
    z_hat = read(address(queries(z), w, shrink, num), w, num).float()
    b, c, t, h, wd = z.shape
    return z_hat.reshape(b, t, h, wd, c).movedim(-1, 1)


def decode(z_hat: torch.Tensor, w: Weights, num: Numerics) -> torch.Tensor:
    y = z_hat
    for i in range(4):
        k = 3 * i
        last = i == 3
        y = num.deconv3d(y, w[f"decoder.{k}.weight"], w[f"decoder.{k}.bias"],
                         (1, 2, 2) if last else 2, (0, 1, 1) if last else 1)
        if not last:
            y = F.leaky_relu(batch_norm(y, w, f"decoder.{k + 1}"), SLOPE)
    return y


def frame_scores(x: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """``[B, 1, T, H, W]`` each -> each frame's mean squared error ``[B, T]``."""
    return torch.square(x - recon.float()).mean(dim=(3, 4))[:, 0]


@torch.no_grad()
def score_clips(u8: torch.Tensor, w: Weights, cfg: dict, num: Numerics,
                encoder=None, mem=None):
    """RGB uint8 clips ``[B, T, H, W, 3]`` -> ``(frame scores [B, T], z
    [B, w3, t, h, w])``, ``BLOCK`` clips at a time.  ``encoder``/``mem``
    replace the stages ``encode``/``memory`` (callables of z and x)."""
    encoder = encoder or (lambda x: encode(x, w, num))
    mem = mem or (lambda z: memory(z, w, cfg["shrink_thres"], num))
    scores, zs = [], []
    for lo in range(0, u8.shape[0], BLOCK):
        x = gray(u8[lo:lo + BLOCK])
        z = encoder(x)
        scores.append(frame_scores(x, decode(mem(z), w, num)))
        zs.append(z)
    return torch.cat(scores), torch.cat(zs)


class _Stage(torch.nn.Module):
    """A stage of the reference as a module, so that the runner's forward
    hooks see it as they see the program's."""

    def __init__(self, fn) -> None:
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class ReferenceClipScorer:
    """The reference as a stand-in for the port's multi-stream scorer of a
    clip model: the same slots, chunk, ``score_chunk`` and no carried
    state; ``model.encoder`` and ``model.mem_rep`` are its stages.  With
    ``Numerics('fp8')`` it is the scoring cell's control."""

    def __init__(self, cfg: dict, weights: Weights, num_slots: int, chunk: int,
                 numerics: str, device) -> None:
        self.cfg, self.w, self.num = cfg, weights, Numerics(numerics)
        self.num_slots, self.chunk, self.device = num_slots, chunk, torch.device(device)
        self.image_size = cfg["image_size"]
        self.image_hw = (cfg["image_size"], cfg["image_size"])
        self.dtype = torch.float32
        self.fused_input = False
        self.states = ()
        self.model = torch.nn.Module()
        self.model.encoder = _Stage(lambda x: encode(x, self.w, self.num))
        self.model.mem_rep = _Stage(lambda z: memory(z, self.w, cfg["shrink_thres"], self.num))
        self._active = np.zeros(num_slots, dtype=bool)

    @property
    def active_slots(self) -> np.ndarray:
        return np.flatnonzero(self._active)

    def attach(self, slot=None) -> int:
        if slot is None:
            free = np.flatnonzero(~self._active)
            if len(free) == 0:
                raise RuntimeError(f"all {self.num_slots} stream slots busy")
            slot = int(free[0])
        self._active[slot] = True
        return slot

    def detach(self, slot: int) -> None:
        self._active[slot] = False

    def score_chunk(self, frames_u8, submitted=None):
        u8 = torch.as_tensor(frames_u8, device=self.device)
        with exact_f32():
            scores, _ = score_clips(u8, self.w, self.cfg, self.num, self.model.encoder,
                                    self.model.mem_rep)
        out = scores.cpu().numpy()
        out[~self._active] = np.nan
        return out
