"""Plain PyTorch reference of the ConvLSTM video autoencoder.

The model of github.com/KuldeepChoksi/video-anomaly-detection
(``models/video_autoencoder.py``) as the port serves and trains it:
4 x (conv3x3 + BatchNorm + 2x2 max-pool + LeakyReLU 0.2) per frame, a
2-layer ConvLSTM whose gates (i, f, g, o) come from one 3x3 convolution
over [x, h], an optional 1x1 projection, 4 x ConvTranspose 2x2/2 (BatchNorm
and ReLU after the first three, tanh after the last), and per-frame scores
mean((x - recon)^2) with x = u8 / 127.5 - 1.

Written from that description with ``torch.nn.functional`` alone, in
float32 with TF32 off; it imports nothing of the program.  Weights are a
flat dict in the layout that ``layout`` lists (the names and shapes the
benchmark hands to both sides).  BatchNorm in training mode is Flax's:
the batch mean and the biased variance E[x^2] - E[x]^2.

``Numerics`` names the arithmetic: ``f32`` is the reference itself; the
controls put it in the program's place one precision lower than the cell
states: ``fp8`` (e4m3 operands of every convolution, scaled per tensor,
bfloat16 results) for bfloat16 serving, ``tf32`` (operands of every
convolution rounded to TF32's 10-bit mantissa, float32 sums) for float32
training.  Both are emulated, so they read the same on any device.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9
SLOPE = 0.2
ENCODER_WIDTHS = (32, 64, 128)
DECODER_WIDTHS = (128, 64, 32)
FP8_MAX = 448.0
# the sizes a CPU test run of this model uses (``benchmark/tests/cases.py``)
TINY = {"image_size": 32, "latent_dim": 16, "lstm_hidden_dim": 16, "sequence_length": 4}

Weights = Dict[str, torch.Tensor]
State = Tuple[torch.Tensor, torch.Tensor]


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """Every weight's name and shape (conv kernels OIHW, ConvTranspose
    kernels IOHW, each ConvLSTM layer's gate kernel split into ``w_x``
    [4H,I,3,3] over the input and ``w_h`` [3,3,H,4H] over h)."""
    latent, hidden = cfg["latent_dim"], cfg["lstm_hidden_dim"]
    out = []

    def norm(prefix, ch):
        out.extend((f"{prefix}.{k}", (ch,)) for k in ("weight", "bias", "running_mean",
                                                     "running_var"))

    enc = (*ENCODER_WIDTHS, latent)
    for i, (ci, co) in enumerate(zip((cfg["in_channels"], *enc[:-1]), enc)):
        out += [(f"encoder.convs.{i}.weight", (co, ci, 3, 3)), (f"encoder.convs.{i}.bias", (co,))]
    for i, co in enumerate(enc):
        norm(f"encoder.norms.{i}", co)
    for k in range(cfg["lstm_layers"]):
        cin = latent if k == 0 else hidden
        out += [(f"convlstm.layers.{k}.w_x", (4 * hidden, cin, 3, 3)),
                (f"convlstm.layers.{k}.w_h", (3, 3, hidden, 4 * hidden)),
                (f"convlstm.layers.{k}.bias", (4 * hidden,))]
    if hidden != latent:
        out += [("proj.weight", (latent, hidden, 1, 1)), ("proj.bias", (latent,))]
    dec_out = (*DECODER_WIDTHS, cfg["in_channels"])
    for i, (ci, co) in enumerate(zip((latent, *DECODER_WIDTHS), dec_out)):
        out += [(f"decoder.deconvs.{i}.weight", (ci, co, 2, 2)),
                (f"decoder.deconvs.{i}.bias", (co,))]
    for i, co in enumerate(DECODER_WIDTHS):
        norm(f"decoder.norms.{i}", co)
    return out


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


class Numerics:
    """The arithmetic of every convolution (module docstring)."""

    KINDS = ("f32", "tf32", "fp8")

    def __init__(self, kind: str = "f32"):
        if kind not in self.KINDS:
            raise ValueError(f"unknown numerics {kind!r}; expected one of {self.KINDS}")
        self.kind = kind

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """An operand as the lower precision holds it (its gradient passes
        straight through, as the backward products take the rounded
        operands)."""
        if self.kind == "tf32":
            bits = x.detach().contiguous().view(torch.int32)
            # round to nearest (ties away) at bit 13, as the tensor cores' input rounding
            held = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        elif self.kind == "fp8":
            scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
            held = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        else:
            return x
        return x + (held - x.detach())

    def value(self, x: torch.Tensor) -> torch.Tensor:
        """A value held in the compute type (the input, the scores): fp8
        keeps it in e4m3, scaled per tensor."""
        return self.operand(x) if self.kind == "fp8" else x

    def result(self, y: torch.Tensor) -> torch.Tensor:
        return y.to(torch.bfloat16).float() if self.kind == "fp8" else y

    def conv(self, x, w, b, **kw):
        y = F.conv2d(self.operand(x), self.operand(w), None, **kw)
        return self.result(y if b is None else y + b[:, None, None])

    def deconv(self, x, w, b):
        y = F.conv_transpose2d(self.operand(x), self.operand(w), None, stride=2)
        return self.result(y + b[:, None, None])


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN and cuBLAS inside the block (restored after)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def batch_norm(y: torch.Tensor, w: Weights, prefix: str, train: bool) -> torch.Tensor:
    if train:
        mean = y.mean(dim=(0, 2, 3))
        var = torch.clamp_min(torch.square(y).mean(dim=(0, 2, 3)) - torch.square(mean), 0.0)
    else:
        mean, var = w[f"{prefix}.running_mean"], w[f"{prefix}.running_var"]
    scale = torch.rsqrt(var + BN_EPS) * w[f"{prefix}.weight"]
    return (y - mean[:, None, None]) * scale[:, None, None] + w[f"{prefix}.bias"][:, None, None]


def encode(x: torch.Tensor, w: Weights, num: Numerics, train: bool) -> torch.Tensor:
    """Frames ``[N,3,H,W]`` in [-1, 1] -> latents ``[N,latent,H/16,W/16]``."""
    y = x
    for i in range(4):
        y = num.conv(y, w[f"encoder.convs.{i}.weight"], w[f"encoder.convs.{i}.bias"], padding=1)
        y = batch_norm(y, w, f"encoder.norms.{i}", train)
        y = F.leaky_relu(F.max_pool2d(y, 2), SLOPE)
    return y


def convlstm(z: torch.Tensor, w: Weights, states: Sequence[State], num: Numerics):
    """``z [B,T,C,h,w]``, per-layer ``(h, c) [B,H,h,w]`` -> the last layer's
    hidden sequence ``[B,T,H,h,w]`` and every layer's final (h, c)."""
    b, t = z.shape[:2]
    finals = []
    for k, (h, c) in enumerate(states):
        w_x, w_h = w[f"convlstm.layers.{k}.w_x"], w[f"convlstm.layers.{k}.w_h"]
        w_h = w_h.permute(3, 2, 0, 1)  # HWIO -> OIHW
        gx = num.conv(z.reshape(b * t, *z.shape[2:]), w_x, w[f"convlstm.layers.{k}.bias"],
                      padding=1)
        gx = gx.reshape(b, t, *gx.shape[1:])
        hs = []
        for s in range(t):
            gates = gx[:, s] + num.conv(h, w_h, None, padding=1)
            i, f, g, o = gates.chunk(4, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(num.result(h))
        finals.append((h, c))
        z = torch.stack(hs, dim=1)
    return z, finals


def decode(z: torch.Tensor, w: Weights, num: Numerics, train: bool) -> torch.Tensor:
    y = z
    for i in range(3):
        y = num.deconv(y, w[f"decoder.deconvs.{i}.weight"], w[f"decoder.deconvs.{i}.bias"])
        y = F.relu(batch_norm(y, w, f"decoder.norms.{i}", train))
    return torch.tanh(num.deconv(y, w["decoder.deconvs.3.weight"], w["decoder.deconvs.3.bias"]))


def forward(x: torch.Tensor, w: Weights, states, num: Numerics, train: bool):
    """``x [B,T,3,H,W]`` -> ``(recon [B,T,3,H,W], final states)``."""
    b, t = x.shape[:2]
    z = encode(x.reshape(b * t, *x.shape[2:]), w, num, train)
    z, finals = convlstm(z.reshape(b, t, *z.shape[1:]), w, states, num)
    z = z.reshape(b * t, *z.shape[2:])
    if "proj.weight" in w:
        z = num.conv(z, w["proj.weight"], w["proj.bias"])
    return decode(z, w, num, train).reshape(x.shape), finals


def normalize(u8: torch.Tensor) -> torch.Tensor:
    """uint8 ``[B,T,H,W,3]`` -> float32 ``[B,T,3,H,W]`` in [-1, 1]."""
    return u8.float().div(127.5).sub(1.0).permute(0, 1, 4, 2, 3)


def zero_states(cfg: dict, batch: int, hw: Tuple[int, int], device) -> Tuple[State, ...]:
    """Per-layer zero (h, c) ``[B,h,w,H]`` f32, channels last."""
    shape = (batch, hw[0] // 16, hw[1] // 16, cfg["lstm_hidden_dim"])
    return tuple((torch.zeros(shape, device=device), torch.zeros(shape, device=device))
                 for _ in range(cfg["lstm_layers"]))


@torch.no_grad()
def score_chunk(w: Weights, u8: torch.Tensor, states, num: Numerics):
    """One chunk ``u8 [B,T,H,W,3]`` from per-layer ``(h, c) [B,h,w,H]``:
    ``(frame scores [B,T] f32, new states [B,h,w,H] f32)``."""
    x = num.value(normalize(u8))
    nchw = [(h.permute(0, 3, 1, 2), c.permute(0, 3, 1, 2)) for h, c in states]
    recon, finals = forward(x, w, nchw, num, train=False)
    # the scores in the compute type, as the program returns its own
    scores = num.value(torch.square(x - recon).mean(dim=(2, 3, 4)))
    return scores, tuple((h.permute(0, 2, 3, 1).contiguous(), c.permute(0, 2, 3, 1).contiguous())
                         for h, c in finals)


class ReferenceScorer:
    """The reference as a stand-in for the port's multi-stream scorer: the
    same slots, chunk, ``score_chunk`` and carried ``states`` (only
    submitting slots advance).  With ``Numerics('fp8')`` it is the scoring
    cells' control."""

    def __init__(self, cfg: dict, weights: Weights, num_slots: int, chunk: int,
                 numerics: str, device) -> None:
        self.cfg, self.w, self.num = cfg, weights, Numerics(numerics)
        self.num_slots, self.chunk, self.device = num_slots, chunk, torch.device(device)
        self.image_size = cfg["image_size"]
        self.image_hw = (cfg["image_size"], cfg["image_size"])
        self.dtype = torch.float32
        self.fused_input = False
        self._active = np.zeros(num_slots, dtype=bool)
        self.states = zero_states(cfg, num_slots, self.image_hw, self.device)

    @property
    def model(self):
        return self

    @property
    def active_slots(self) -> np.ndarray:
        return np.flatnonzero(self._active)

    def attach(self, slot=None) -> int:
        if slot is None:
            free = np.flatnonzero(~self._active)
            if len(free) == 0:
                raise RuntimeError(f"all {self.num_slots} stream slots busy")
            slot = int(free[0])
        for h, c in self.states:
            h[slot] = 0
            c[slot] = 0
        self._active[slot] = True
        return slot

    def detach(self, slot: int) -> None:
        self._active[slot] = False

    def score_chunk(self, frames_u8, submitted=None):
        if submitted is None:
            submitted = self._active
        u8 = torch.as_tensor(frames_u8, device=self.device)
        with exact_f32():
            scores, new = score_chunk(self.w, u8, self.states, self.num)
        keep = torch.as_tensor(np.asarray(submitted, bool), device=self.device)[:, None, None, None]
        self.states = tuple((torch.where(keep, hn, ho), torch.where(keep, cn, co))
                            for (hn, cn), (ho, co) in zip(new, self.states))
        out = scores.cpu().numpy()
        out[~self._active] = np.nan
        return out


def train_loss(w: Weights, u8: torch.Tensor, cfg: dict, num: Numerics) -> torch.Tensor:
    """The mean over the batch of each sample's MSE in training mode
    (BatchNorm on batch statistics), from zero states."""
    x = normalize(u8)
    states = [(torch.zeros_like(h).permute(0, 3, 1, 2), torch.zeros_like(c).permute(0, 3, 1, 2))
              for h, c in zero_states(cfg, x.shape[0], x.shape[-2:], x.device)]
    recon, _ = forward(x, w, states, num, train=True)
    return torch.square(recon - x).reshape(x.shape[0], -1).mean(dim=1).mean()


def train_steps(w0: Weights, batches: Sequence[torch.Tensor], cfg: dict, lr: float,
                weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8,
                numerics: str = "f32", start=None):
    """Adam (weight decay added to the gradient before the moments) over
    ``batches``: ``(losses, first gradients, parameters after the last
    step)``, the gradients and parameters by name (parameters only:
    running statistics are not trained).  It starts from the weights
    ``w0`` and Adam's zero state, or from ``start``: ``(parameters, first
    moments, second moments, steps taken)`` by name, where a trained
    model stood (the buffers still come from ``w0``)."""
    num = Numerics(numerics)
    buffers = {k: v for k, v in w0.items() if is_buffer(k)}
    if start is None:
        params = {k: v.detach().clone().float() for k, v in w0.items() if not is_buffer(k)}
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v2 = {k: torch.zeros_like(v) for k, v in params.items()}
        taken = 0
    else:
        params, m, v2 = ({k: t.detach().clone().float() for k, t in part.items()}
                         for part in start[:3])
        taken = int(start[3])
    losses, first = [], None
    with exact_f32():
        for step, u8 in enumerate(batches, start=taken + 1):
            leaves = {k: p.requires_grad_(True) for k, p in params.items()}
            loss = train_loss({**leaves, **buffers}, u8, cfg, num)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                if first is None:
                    first = {k: g.clone() for k, g in zip(leaves, grads)}
                b1, b2 = betas
                new = {}
                for (k, p), g in zip(leaves.items(), grads):
                    g = g + weight_decay * p
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v2[k].sqrt() / (1 - b2 ** step) ** 0.5).add_(eps)
                    new[k] = p - (lr / (1 - b1 ** step)) * m[k] / denom
            params = {k: p.detach() for k, p in new.items()}
    return losses, first, params
