"""MemAE: the memory-augmented 3D-convolutional video autoencoder.

Gong et al., "Memorizing Normality to Detect Anomaly: Memory-augmented
Deep Autoencoder for Unsupervised Anomaly Detection", ICCV 2019
(arXiv:1904.02639), as its official code builds it
(github.com/donggong1/memae-anomaly-detection: ``models/memae_3dconv.py``
``AutoEncoderCov3DMem``, ``models/memory_module.py`` ``MemModule``,
``MemoryUnit``, ``hard_shrink_relu``), under the same module names, so one
of its state dicts loads with ``strict=True``:

- encoder: 4 x (Conv3d 3x3x3, padding 1 + BatchNorm3d + LeakyReLU 0.2),
  widths in -> 96 (stride (1, 2, 2)) -> 128 -> 256 -> 256 (stride 2): a
  clip ``[C, T, H, W]`` becomes z ``[256, T/8, H/16, W/16]``;
- memory: M ``[mem_dim, 256]``, no bias.  Each position's 256-d query z
  reads w = softmax(z M^T), hard-shrunk at lambda
  (relu(w - lambda) w / (|w - lambda| + 1e-12)), L1-normalised, then
  z_hat = w M;
- decoder: the encoder's mirror in ConvTranspose3d 3x3x3 (padding 1,
  output padding 1; the last stride (1, 2, 2), output padding (0, 1, 1)),
  BatchNorm3d + LeakyReLU after all but the last, no output activation.

The model carries no state from one clip to the next.  ``score_clips``
takes the RGB uint8 clips every stream sends, turns them gray on the
device first (BT.601: 0.299 R + 0.587 G + 0.114 B of u8 / 127.5 - 1) and
scores each frame by the mean squared error of its reconstruction, in
float32.  The convolutions run in the type ``cast_for_scoring`` gave them,
on channels-last-3d (NDHWC) tensors; the memory's addressing and read run
in float32 with TF32 off whatever that type is, as the official code
computes them: the shrinkage is discontinuous at lambda, and a weight
rounded across it adds or drops a whole item of the read.  Scoring runs in
eval mode (BatchNorm on its running statistics).

The scorer runs inference BatchNorm3d folded into the convolutions:
``fold_for_scoring`` folds the four encoder layers and the decoder's first
three off a state dict taken before ``cast_for_scoring`` (the math is
``ops/block_epilogue.fold_conv_bn``), and ``forward(x, folded)`` runs each
folded layer as its bias-free convolution and one epilogue pass of bias
and LeakyReLU (``block_epilogue``'s ``leaky`` mode: kernel 7 on the card).
The encoder and decoder are still called as modules, so forward hooks on
them and on ``mem_rep`` see z and z_hat on either path.
"""

from __future__ import annotations

import contextlib
import math
from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vad_tpu_torch.core.config import MemAEConfig
from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.ops import block_epilogue as epilogue_ops
from vad_tpu_torch.utils.profiling import span

NEGATIVE_SLOPE = 0.2
SHRINK_EPS = 1e-12  # hard_shrink_relu's epsilon
GRAY = (0.299, 0.587, 0.114)  # BT.601 luma weights of R, G, B


def hard_shrink_relu(w: torch.Tensor, lambd: float, eps: float = SHRINK_EPS) -> torch.Tensor:
    """relu(w - lambda) * w / (|w - lambda| + eps): w where it exceeds
    lambda, else 0 (the official ``hard_shrink_relu``)."""
    return F.relu(w - lambd) * w / (torch.abs(w - lambd) + eps)


@contextlib.contextmanager
def _no_tf32():
    """float32 products in full precision inside the block (restored after)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


class MemoryUnit(nn.Module):
    """The memory M ``[mem_dim, fea_dim]`` and its sparse read."""

    def __init__(self, mem_dim: int, fea_dim: int, shrink_thres: float = 0.0025):
        super().__init__()
        self.mem_dim, self.fea_dim, self.shrink_thres = mem_dim, fea_dim, shrink_thres
        self.weight = nn.Parameter(torch.empty(mem_dim, fea_dim))
        bound = 1.0 / math.sqrt(fea_dim)  # the official reset_parameters
        nn.init.uniform_(self.weight, -bound, bound)

    def address(self, q: torch.Tensor) -> torch.Tensor:
        """Queries ``[N, fea_dim]`` -> the read's weights ``[N, mem_dim]``:
        softmax over the items, hard-shrunk and L1-normalised (no shrinkage
        at lambda = 0, as in the official code)."""
        w = F.softmax(F.linear(q, self.weight), dim=1)
        if self.shrink_thres > 0:
            w = F.normalize(hard_shrink_relu(w, self.shrink_thres), p=1, dim=1)
        return w

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return self.address(q) @ self.weight


class MemModule(nn.Module):
    """The memory over a feature volume ``[N, C, T, H, W]``: every position
    is one query.  Returns z_hat in float32 (any input type)."""

    def __init__(self, mem_dim: int, fea_dim: int, shrink_thres: float = 0.0025):
        super().__init__()
        self.memory = MemoryUnit(mem_dim, fea_dim, shrink_thres)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        n, c, t, h, w = z.shape
        queries = z.float().movedim(1, -1).reshape(-1, c)  # a view of a channels-last-3d z
        with _no_tf32():
            out = self.memory(queries)
        return out.reshape(n, t, h, w, c).movedim(-1, 1)


class FoldedLayers(NamedTuple):
    """A ``MemAutoencoder``'s layers with inference BatchNorm3d folded in,
    as ``forward(x, folded)`` runs them: the four ``encoder`` layers (Conv3d
    weights ``[out, in, 3, 3, 3]``) and the first three ``decoder`` layers
    (ConvTranspose3d weights ``[in, out, 3, 3, 3]``), each ``(weight in the
    scoring type, channels-last-3d; bias f32)``.  The decoder's output
    layer has no BatchNorm and runs as its module."""

    encoder: Tuple[epilogue_ops.Layer, ...]
    decoder: Tuple[epilogue_ops.Layer, ...]


def _channels_last_3d(w: torch.Tensor) -> torch.Tensor:
    """A copy of ``w`` with channels-last-3d strides, also where dim 1 has
    size 1 (``contiguous(memory_format=...)`` leaves such a tensor's
    strides as they are, and PyTorch then runs the layer as NCDHW)."""
    _, c, d, h, w_ = w.shape
    out = torch.empty_strided(w.shape, (c * d * h * w_, 1, h * w_ * c, w_ * c, c),
                              dtype=w.dtype, device=w.device)
    return out.copy_(w)


def _leaky_epilogue(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``leaky_relu(y + bias, 0.2)`` over a channels-last-3d ``[N, C, T,
    H, W]`` convolution output in one pass: the frames ``[N*T, H, W, C]``
    through ``block_epilogue``'s ``leaky`` mode; the result comes back
    channels-last-3d."""
    n, c, t, h, w = y.shape
    frames = y.permute(0, 2, 3, 4, 1).reshape(n * t, h, w, c)  # a view of channels-last-3d
    out = epilogue_ops.block_epilogue(frames.permute(0, 3, 1, 2), bias, "leaky")
    return out.permute(0, 2, 3, 1).reshape(n, t, h, w, c).permute(0, 4, 1, 2, 3)


class _Layers(nn.Sequential):
    """The official encoder or decoder (its modules and state-dict keys),
    whose ``forward`` also takes that part's folded layers."""

    def forward(self, x: torch.Tensor,
                folded: Optional[Sequence[epilogue_ops.Layer]] = None) -> torch.Tensor:
        """The modules in order; with ``folded``, each folded layer as its
        bias-free convolution ending in one epilogue pass, and the layers
        after them (the decoder's output layer) as their modules."""
        if folded is None:
            return super().forward(x)
        convs = [m for m in self if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d))]
        for conv, (w, b) in zip(convs, folded):
            # each activation is freed once the next one exists, as on the
            # module path: a layer's input is not held through its epilogue
            y = _bias_free(conv, x, w)
            del x
            x = _leaky_epilogue(y, b)
            del y
        for conv in convs[len(folded):]:
            x = conv(x)
        return x


def _bias_free(conv: nn.Module, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``conv``'s convolution of ``x`` with the weight ``w`` and no bias."""
    if isinstance(conv, nn.ConvTranspose3d):
        return F.conv_transpose3d(x, w, None, conv.stride, conv.padding, conv.output_padding)
    return F.conv3d(x, w, None, conv.stride, conv.padding)


def _encoder(in_channels: int, widths: Sequence[int]) -> _Layers:
    layers = []
    for i, (ci, co) in enumerate(zip((in_channels, *widths[:-1]), widths)):
        layers += [nn.Conv3d(ci, co, 3, stride=(1, 2, 2) if i == 0 else 2, padding=1),
                   nn.BatchNorm3d(co), nn.LeakyReLU(NEGATIVE_SLOPE, inplace=True)]
    return _Layers(*layers)


def _decoder(in_channels: int, widths: Sequence[int]) -> _Layers:
    layers = []
    ins, outs = widths[::-1], (*widths[-2::-1], in_channels)
    for i, (ci, co) in enumerate(zip(ins, outs)):
        if i == len(widths) - 1:  # back to the input's frames and channels
            layers.append(nn.ConvTranspose3d(ci, co, 3, stride=(1, 2, 2), padding=1,
                                             output_padding=(0, 1, 1)))
        else:
            layers += [nn.ConvTranspose3d(ci, co, 3, stride=2, padding=1, output_padding=1),
                       nn.BatchNorm3d(co), nn.LeakyReLU(NEGATIVE_SLOPE, inplace=True)]
    return _Layers(*layers)


def gray(u8: torch.Tensor) -> torch.Tensor:
    """RGB uint8 ``[..., 3]`` -> float32 ``[...]``: BT.601 luma of u8 /
    127.5 - 1 (the weights sum to 1, so the gray of the normalised
    channels)."""
    r, g, b = (u8[..., k] for k in range(3))
    return (r * GRAY[0] + g * GRAY[1] + b * GRAY[2]).div_(127.5).sub_(1.0)


class MemAutoencoder(nn.Module):
    """``AutoEncoderCov3DMem`` (module docstring).  ``sequence_length`` is
    the clip a stream sends a chunk (a multiple of 8: three stride-2 steps
    in time).  ``device=None`` means CUDA and raises when there is none."""

    def __init__(self, in_channels: int = 1, widths: Tuple[int, ...] = (96, 128, 256, 256),
                 mem_dim: int = 2000, shrink_thres: float = 0.0025, sequence_length: int = 16,
                 device=None):
        super().__init__()
        if len(widths) != 4:
            raise ValueError(f"MemAE has four encoder widths, got {tuple(widths)}")
        if in_channels != 1:
            raise ValueError("MemAE scores gray clips (in_channels=1)")
        if sequence_length % 8:
            raise ValueError(f"a MemAE clip's length must divide by 8, got {sequence_length}")
        device = resolve_device(device)
        self.in_channels, self.widths = in_channels, tuple(widths)
        self.sequence_length = sequence_length
        self.encoder = _encoder(in_channels, self.widths)
        self.mem_rep = MemModule(mem_dim, self.widths[-1], shrink_thres)
        self.decoder = _decoder(in_channels, self.widths)
        self.to(device)

    @classmethod
    def from_config(cls, cfg: MemAEConfig, device=None) -> "MemAutoencoder":
        return cls(cfg.in_channels, cfg.widths, cfg.mem_dim, cfg.shrink_thres,
                   cfg.sequence_length, device=device)

    @property
    def device(self) -> torch.device:
        return self.mem_rep.memory.weight.device

    def cast_for_scoring(self, dtype: torch.dtype) -> "MemAutoencoder":
        """The convolutions and their BatchNorms in ``dtype``, their kernels
        channels-last-3d; M stays float32."""
        for part in (self.encoder, self.decoder):
            part.to(dtype=dtype, memory_format=torch.channels_last_3d)
        return self

    def forward(self, x: torch.Tensor, folded: Optional[FoldedLayers] = None) -> torch.Tensor:
        """Clips ``[N, C, T, H, W]`` in [-1, 1] -> reconstructions of the
        same shape and type; with ``folded`` (``fold_for_scoring``, eval
        mode only) the encoder and decoder run their folded layers."""
        enc, dec = (None, None) if folded is None else folded
        with span("vad.model.encoder"):
            z = self.encoder(x, enc)
        with span("vad.model.memory"):
            z_hat = self.mem_rep(z)
        with span("vad.model.decoder"):
            return self.decoder(z_hat.to(z.dtype), dec)

    def score_clips(self, u8: torch.Tensor, compute_err_map: bool = True,
                    folded: Optional[FoldedLayers] = None):
        """RGB uint8 clips ``[B, T, H, W, 3]`` -> ``(recon [B, T, H, W] in
        the convolutions' type, error maps [B, T, H, W] float32 or None,
        frame scores [B, T] float32)``; ``folded`` as in ``forward``."""
        x = gray(u8)
        dtype = self.encoder[0].weight.dtype
        clips = x.to(dtype)[:, None].contiguous(memory_format=torch.channels_last_3d)
        recon = self(clips, folded)[:, 0]
        err = torch.square(x - recon.float())
        return recon, (err if compute_err_map else None), err.mean(dim=(2, 3))


def fold_for_scoring(state_dict: Mapping[str, torch.Tensor], dtype: torch.dtype,
                     device=None) -> FoldedLayers:
    """Fold inference BatchNorm3d into the four encoder layers and the
    decoder's first three of a ``MemAutoencoder`` state dict taken before
    ``cast_for_scoring``: weights cast to ``dtype`` in channels-last-3d,
    biases f32, all on ``device``.  Raises ValueError for weights or
    statistics below float32 (a state dict taken after the cast)."""

    def fold(part: str, i: int, out_dim: int) -> epilogue_ops.Layer:
        conv, norm = f"{part}.{3 * i}", f"{part}.{3 * i + 1}"
        read = [state_dict[f"{conv}.{k}"] for k in ("weight", "bias")]
        read += [state_dict[f"{norm}.{k}"] for k in ("running_mean", "running_var", "weight",
                                                      "bias")]
        if any(torch.finfo(t.dtype).bits < 32 for t in read):
            raise ValueError(f"the fold reads {conv} and {norm} in float32 or wider, before "
                             "cast_for_scoring; got " + ", ".join(str(t.dtype) for t in read))
        w, b = epilogue_ops.fold_conv_bn(*read, out_dim)
        return (_channels_last_3d(w.to(device=device, dtype=dtype)),
                b.to(device=device, dtype=torch.float32))

    layers = sum(k.startswith("encoder.") and k.endswith(".running_mean") for k in state_dict)
    return FoldedLayers(tuple(fold("encoder", i, 0) for i in range(layers)),
                        tuple(fold("decoder", i, 1) for i in range(layers - 1)))

