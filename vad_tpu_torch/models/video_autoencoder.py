"""ConvLSTM video autoencoder (PyTorch port of the JAX package's model).

Encoder (4x conv3x3 + norm + 2x2 max-pool + LeakyReLU) -> 2-layer
ConvLSTM -> optional 1x1 projection -> decoder (4x ConvTranspose 2x2
stride 2, tanh out).  Public functions keep the JAX layout (NHWC frames,
``[B,T,H,W,C]`` sequences); inside, NHWC tensors are viewed as
channels-last NCHW, so cuDNN reads them without copies.

The ConvLSTM's gate convolution over concat([x, h]) is split into
conv(x, Wx) — one batched cuDNN convolution over all B*T frames, hoisted
out of the time loop — and the recurrence over conv(h, Wh), which runs
through ``ops/convlstm.py``: on the card kernel 1 when nothing is
differentiated, kernels 2 and 3 (forward and backward) under autograd.

Modules follow ``train()``/``eval()`` as any ``nn.Module``: a model is
built in train mode, and BatchNorm then uses batch statistics (Flax's
train-mode semantics, ``models/norms.py``).  The scoring methods
(``stream_step``, ``stream_step_u8``, ``stream_step_fast``, ``error_map``,
``reconstruction_error``, ``prediction_error``) are the JAX model's
``train=False`` calls: run them in eval mode (``MultiStreamScorer`` and the
trainer's eval step do).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vad_tpu_torch.core.config import VideoAEConfig
from vad_tpu_torch.core.device import resolve_device
from vad_tpu_torch.models.norms import make_norm
from vad_tpu_torch.ops import block_epilogue as epilogue_ops
from vad_tpu_torch.ops import convlstm as convlstm_ops
from vad_tpu_torch.ops import encoder_fused
from vad_tpu_torch.ops.decoder_fast import decode_quadtree, quadtree_view, raster_from_quadtree
from vad_tpu_torch.ops.convlstm import convlstm_step  # noqa: F401  (public API)
from vad_tpu_torch.utils.profiling import span

State = Tuple[torch.Tensor, torch.Tensor]
ENCODER_WIDTHS = (32, 64, 128)  # + latent_dim
DECODER_WIDTHS = (128, 64, 32)  # + out channels
NEGATIVE_SLOPE = 0.2


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view (channels-last strides when x is contiguous)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC (a view when x is channels-last)."""
    return x.permute(0, 2, 3, 1).contiguous()


def _flatten_time(x: torch.Tensor):
    if x.dim() == 5:
        return x.reshape(-1, *x.shape[2:]), x.shape[:2]
    return x, None


class ConvLSTMLayer(nn.Module):
    """One ConvLSTM layer over the full time axis.

    ``w_x [4H,I,3,3]`` (OIHW, cuDNN's) and ``w_h [3,3,H,4H]`` (HWIO, the
    recurrence's) are the two halves of the JAX layer's fused kernel
    ``[3,3,I+H,4H]``; the gate order is (i, f, g, o).

    Under tensor parallelism (``tp_mesh``, set by
    ``parallel.sharding.distribute``) the three parameters hold this rank's
    slice of the 4H channels and the layer all-gathers the full weights
    over the model group first, so the recurrence kernels see whole
    operands."""

    def __init__(self, input_dim: int, hidden_dim: int, remat: bool = False):
        super().__init__()
        self.input_dim, self.hidden_dim, self.remat = input_dim, hidden_dim, remat
        self.tp_mesh = None
        self.w_x = nn.Parameter(torch.empty(4 * hidden_dim, input_dim, 3, 3))
        self.w_h = nn.Parameter(torch.empty(3, 3, hidden_dim, 4 * hidden_dim))
        self.bias = nn.Parameter(torch.zeros(4 * hidden_dim))
        fan = 9 * (input_dim + hidden_dim)
        std = math.sqrt(2.0 / (fan + 9 * 4 * hidden_dim))
        nn.init.normal_(self.w_x, std=std)
        nn.init.normal_(self.w_h, std=std)

    def forward(self, x_seq: torch.Tensor, initial_state: Optional[State] = None):
        """``[B,T,H,W,I]`` -> ``(h_seq [B,T,H,W,Hd], (h_T, c_T) f32)``.

        ``remat`` recomputes each step in the backward pass on the plain
        recurrence (``convlstm_recurrence_ref``); on the kernel path it
        changes nothing, as on the JAX package's Pallas path."""
        b, t, hgt, wid, _ = x_seq.shape
        w_x, w_h, bias = self.w_x, self.w_h, self.bias
        if self.tp_mesh is not None:
            from vad_tpu_torch.parallel.sharding import GATE_DIMS, gather_slices

            w_x, w_h, bias = gather_slices((w_x, w_h, bias), (GATE_DIMS["w_x"], GATE_DIMS["w_h"],
                                                              GATE_DIMS["bias"]), self.tp_mesh)
        flat = _nchw(x_seq.reshape(b * t, hgt, wid, self.input_dim))
        gates_x = _nhwc(F.conv2d(flat, w_x, bias, padding=1))
        gates_x = gates_x.reshape(b, t, hgt, wid, 4 * self.hidden_dim)
        if initial_state is None:
            h0 = torch.zeros((b, hgt, wid, self.hidden_dim), dtype=torch.float32,
                             device=x_seq.device)
            c0 = torch.zeros_like(h0)
        else:
            h0, c0 = (s.float() for s in initial_state)
        return convlstm_ops.convlstm_recurrence(gates_x, w_h, h0, c0, remat=self.remat)


class ConvLSTM(nn.Module):
    """Stack of ConvLSTM layers; returns the last layer's hidden sequence
    and every layer's final (h, c)."""

    def __init__(self, input_dim: int, hidden_dim: int = 128, num_layers: int = 2,
                 remat: bool = False):
        super().__init__()
        self.hidden_dim, self.num_layers = hidden_dim, num_layers
        self.layers = nn.ModuleList(
            ConvLSTMLayer(input_dim if i == 0 else hidden_dim, hidden_dim, remat)
            for i in range(num_layers)
        )

    def forward(self, x_seq: torch.Tensor, initial_states: Optional[Sequence[State]] = None):
        finals = []
        for i, layer in enumerate(self.layers):
            x_seq, final = layer(x_seq, None if initial_states is None else initial_states[i])
            finals.append(final)
        return x_seq, tuple(finals)

    def zero_state(self, batch: int, height: int, width: int, device=None) -> Tuple[State, ...]:
        shape = (batch, height, width, self.hidden_dim)
        return tuple(
            (torch.zeros(shape, device=device), torch.zeros(shape, device=device))
            for _ in range(self.num_layers)
        )


class VideoEncoder(nn.Module):
    """Per-frame encoder: 4x (conv3x3 + norm + [max-pool] + LeakyReLU),
    channels 3->32->64->128->latent, spatial /16.

    ``stem='stride2'`` downsamples in the conv instead of pooling.  JAX's
    "SAME" padding at stride 2 on even sizes pads (0, 1), where torch's
    ``padding=1`` would pad (1, 1): the input is padded by hand."""

    def __init__(self, in_channels: int = 3, latent_dim: int = 128, norm: str = "batch",
                 stem: str = "pool"):
        super().__init__()
        if stem not in ("pool", "stride2"):
            raise ValueError(f"unknown stem {stem!r}; expected 'pool' or 'stride2'")
        self.stem = stem
        widths = (*ENCODER_WIDTHS, latent_dim)
        cins = (in_channels, *widths[:-1])
        stride, pad = (2, 0) if stem == "stride2" else (1, 1)
        self.convs = nn.ModuleList(
            nn.Conv2d(ci, co, 3, stride=stride, padding=pad) for ci, co in zip(cins, widths)
        )
        self.norms = nn.ModuleList(make_norm(norm, co) for co in widths)

    def forward(self, x: torch.Tensor, *, return_pyramid: bool = False):
        """``[N,H,W,C]`` or ``[B,T,H,W,C]`` -> features of the same rank.

        ``return_pyramid``: also return every block's output, in block
        order (the finest first), with the leading dims of ``x`` (the latent
        scorer's input)."""
        x, seq = _flatten_time(x)
        y = _nchw(x)
        pyramid = []
        with span("vad.model.encoder"):
            for conv, norm in zip(self.convs, self.norms):
                if self.stem == "stride2":
                    y = F.pad(y, (0, 1, 0, 1))
                y = norm(conv(y))
                if self.stem == "pool":
                    # pool before the activation: LeakyReLU is monotone, so
                    # the two commute and the activation runs on 1/4 the pixels
                    y = F.max_pool2d(y, 2)
                y = F.leaky_relu(y, NEGATIVE_SLOPE)
                if return_pyramid:
                    pyramid.append(y)
        out = _nhwc(y)
        out = out if seq is None else out.reshape(*seq, *out.shape[1:])
        if not return_pyramid:
            return out
        pyramid = [_nhwc(f) for f in pyramid]
        if seq is not None:
            pyramid = [f.reshape(*seq, *f.shape[1:]) for f in pyramid]
        return out, tuple(pyramid)

    def forward_folded(self, z1: torch.Tensor, layers) -> torch.Tensor:
        """Blocks 2-4 of the pool stem with inference BatchNorm folded in:
        ``z1 [B,T,H,W,C1]`` is the fused first block's output, ``layers``
        the ``encoder`` of ``ops/block_epilogue.fold_blocks``.  Each block is
        the bias-free convolution, then one epilogue pass (2x2 max-pool,
        the folded bias, LeakyReLU)."""
        x, seq = _flatten_time(z1)
        y = _nchw(x)
        with span("vad.model.encoder"):
            for w, b in layers:
                y = epilogue_ops.block_epilogue(F.conv2d(y, w, None, padding=1), b, "encoder")
        out = _nhwc(y)
        return out if seq is None else out.reshape(*seq, *out.shape[1:])


class VideoDecoder(nn.Module):
    """Per-frame decoder: 3x (ConvTranspose 2x2/2 + norm + ReLU), then
    ConvTranspose 2x2/2 + tanh; channels latent->128->64->32->out."""

    def __init__(self, latent_dim: int = 128, out_channels: int = 3, norm: str = "batch"):
        super().__init__()
        cins = (latent_dim, *DECODER_WIDTHS)
        couts = (*DECODER_WIDTHS, out_channels)
        self.deconvs = nn.ModuleList(
            nn.ConvTranspose2d(ci, co, 2, stride=2) for ci, co in zip(cins, couts)
        )
        self.norms = nn.ModuleList(make_norm(norm, co) for co in DECODER_WIDTHS)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        z, seq = _flatten_time(z)
        y = _nchw(z)
        with span("vad.model.decoder"):
            for deconv, norm in zip(self.deconvs[:-1], self.norms):
                y = F.relu(norm(deconv(y)))
            out = _nhwc(torch.tanh(self.deconvs[-1](y)))
        return out if seq is None else out.reshape(*seq, *out.shape[1:])

    def forward_folded(self, z: torch.Tensor, layers) -> torch.Tensor:
        """``forward`` with inference BatchNorm folded in: ``layers`` the
        ``decoder`` of ``ops/block_epilogue.fold_blocks``.  Each layer is
        the bias-free ConvTranspose, then one epilogue pass (the folded
        bias and ReLU; the last layer's own bias and tanh)."""
        z, seq = _flatten_time(z)
        y = _nchw(z)
        with span("vad.model.decoder"):
            for i, (w, b) in enumerate(layers):
                mode = "last" if i == len(layers) - 1 else "decoder"
                y = epilogue_ops.block_epilogue(F.conv_transpose2d(y, w, None, stride=2), b, mode)
            out = _nhwc(y)
        return out if seq is None else out.reshape(*seq, *out.shape[1:])


class VideoAutoencoder(nn.Module):
    """Encoder -> ConvLSTM -> (1x1 projection) -> decoder.

    The projection exists only when ``lstm_hidden_dim != latent_dim``.
    ``remat``: see ``ConvLSTMLayer``.  ``device=None`` means CUDA and
    raises when there is none."""

    def __init__(self, in_channels: int = 3, latent_dim: int = 128, lstm_hidden_dim: int = 128,
                 lstm_layers: int = 2, norm: str = "batch", stem: str = "pool",
                 remat: bool = False, device=None):
        super().__init__()
        device = resolve_device(device)
        self.in_channels, self.latent_dim = in_channels, latent_dim
        self.lstm_hidden_dim, self.lstm_layers = lstm_hidden_dim, lstm_layers
        self.norm, self.stem = norm, stem
        self.encoder = VideoEncoder(in_channels, latent_dim, norm, stem)
        self.convlstm = ConvLSTM(latent_dim, lstm_hidden_dim, lstm_layers, remat)
        self.proj = (
            nn.Conv2d(lstm_hidden_dim, latent_dim, 1) if lstm_hidden_dim != latent_dim else None
        )
        self.decoder = VideoDecoder(latent_dim, in_channels, norm)
        self.to(device)

    @classmethod
    def from_config(cls, cfg: VideoAEConfig, device=None) -> "VideoAutoencoder":
        return cls(cfg.in_channels, cfg.latent_dim, cfg.lstm_hidden_dim, cfg.lstm_layers,
                   cfg.norm, cfg.stem, device=device)

    @property
    def device(self) -> torch.device:
        return self.decoder.deconvs[0].weight.device

    def zero_state(self, batch: int, height: int, width: int) -> Tuple[State, ...]:
        """Per-layer f32 (h, c) zeros at the latent size (H/16, W/16)."""
        return self.convlstm.zero_state(batch, height // 16, width // 16, self.device)

    def _temporal(self, z: torch.Tensor, states):
        z, new_states = self.convlstm(z, initial_states=states)
        if self.proj is not None:
            b, t = z.shape[:2]
            z = _nhwc(self.proj(_nchw(z.reshape(b * t, *z.shape[2:]))))
            z = z.reshape(b, t, *z.shape[1:])
        return z, new_states

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B,T,H,W,C]`` -> reconstruction ``[B,T,H,W,C]``."""
        z, _ = self._temporal(self.encoder(x), None)
        return self.decoder(z)

    def feature_pyramid(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Each encoder block's output for frames ``[N,H,W,C]`` or windows
        ``[B,T,H,W,C]``, in block order (the finest first), with the matching
        leading dims (the latent scorer's input; the ConvLSTM plays no
        part).  Run it in eval mode."""
        return self.encoder(x, return_pyramid=True)[1]

    def temporal_features(self, x: torch.Tensor) -> Tuple[torch.Tensor]:
        """The last ConvLSTM layer's hidden maps ``[B,T,h,w,hidden]`` of
        windows ``[B,T,H,W,C]`` as a 1-level pyramid: h_t carries the
        window's history, so motion that contradicts it moves h_t off the
        normal manifold where every frame alone looks normal.  Run it in
        eval mode under ``torch.no_grad()``: the recurrence is then kernel 1
        on the card."""
        return (self.convlstm(self.encoder(x))[0],)

    def stream_step(self, x: torch.Tensor, states):
        """Streaming chunk inference carrying ConvLSTM state across calls.

        ``x [B,T,H,W,C]``; ``states`` per-layer (h, c) from the previous
        chunk (``zero_state`` for the first).  Returns ``(recon, error_map
        [B,T,H,W], frame_scores [B,T], new_states)``."""
        z, new_states = self._temporal(self.encoder(x), states)
        recon = self.decoder(z)
        err = torch.mean(torch.square(x - recon), dim=-1)
        return recon, err, torch.mean(err, dim=(2, 3)), new_states

    def stream_step_u8(self, u8_flat: torch.Tensor, states, w_folded: torch.Tensor,
                       b_folded: torch.Tensor, folded: epilogue_ops.FoldedBlocks,
                       compute_err_map: bool = True,
                       out_dtype: Optional[torch.dtype] = None):
        """``stream_step`` on raw interleaved-RGB bytes ``[B,T,H,W*3]``
        through the fused u8 input block.

        ``w_folded, b_folded``: from ``ops/encoder_fused.fold_first_block``.
        ``out_dtype`` (default: ``w_folded``'s type) is the compute type of
        everything after the fused block.  ``folded``: from
        ``ops/block_epilogue.fold_blocks`` (weights in ``out_dtype``): the
        encoder's blocks 2-4 and the decoder run with inference BatchNorm
        folded in, each ending in one epilogue pass.  Returns ``(recon_flat [B,T,H,W*3], err_map or
        None, frame_scores, new_states)``."""
        if self.stem != "pool":
            raise ValueError(
                "stream_step_u8's fused input block computes conv1+max-pool; "
                "the stride2 stem has no pool (use stream_step)"
            )
        dtype = out_dtype or (w_folded.dtype if w_folded.is_floating_point() else torch.float32)
        b, t, h, w3 = u8_flat.shape
        z1 = encoder_fused.fused_first_block(
            u8_flat.reshape(b * t, h, w3 // 3, 3), w_folded, b_folded, out_dtype=dtype
        )
        z = self.encoder.forward_folded(z1.reshape(b, t, *z1.shape[1:]), folded.encoder)
        z, new_states = self._temporal(z, states)
        rf = self.decoder.forward_folded(z, folded.decoder).reshape(b, t, h, w3)
        xf = u8_flat.to(dtype) / 127.5 - 1.0
        sq = torch.square(xf - rf)
        frame_scores = torch.mean(sq, dim=(2, 3))  # over H, W*3 == frame mean
        err = torch.mean(sq.reshape(b, t, h, w3 // 3, 3), dim=-1) if compute_err_map else None
        return rf, err, frame_scores, new_states

    def stream_step_fast(self, x: torch.Tensor, states, folded, compute_err_map: bool = True):
        """``stream_step`` with the decoder run as folded quadtree products
        (``ops/decoder_fast.py``; ``folded`` from ``fold_decoder_params``,
        inference BatchNorm baked in, so norm='batch' models only).  The
        recurrence is the same call as ``stream_step``'s (kernel 1 on the
        card under ``no_grad``).  Frame scores are taken in quadtree row
        order.  Not used by the serving path (nor in the JAX package).

        Returns ``(recon_quadtree [B*T*H*W, C], err_map or None,
        frame_scores [B, T], new_states)``; ``raster_from_quadtree`` turns
        the reconstruction into frames."""
        z, new_states = self._temporal(self.encoder(x), states)
        recon_q = decode_quadtree(z, folded)
        b, t, h, w, _ = x.shape
        xq = quadtree_view(x)
        pix = torch.mean(torch.square(xq - recon_q.to(xq.dtype)), dim=-1)
        frame_scores = torch.mean(pix.reshape(b, t, -1), dim=-1)
        err = None
        if compute_err_map:
            err = raster_from_quadtree(pix[:, None], (b, t), h, w)[..., 0]
        return recon_q, err, frame_scores, new_states

    def error_map(self, x: torch.Tensor) -> torch.Tensor:
        """Per-pixel, per-frame anomaly map ``[B,T,H,W]``."""
        return torch.mean(torch.square(x - self(x)), dim=-1)

    def prediction_error(self, x: torch.Tensor, per_frame: bool = False,
                         per_pixel: bool = False) -> torch.Tensor:
        """Future-frame prediction error: output t (causal in frames <= t)
        against frame t+1.  Scores at sequence ``[B]``, frame ``[B,T-1]`` or
        pixel ``[B,T-1,H,W]`` granularity, aligned to frames 1..T-1."""
        err = torch.mean(torch.square(x[:, 1:] - self(x)[:, :-1]), dim=-1)
        if per_pixel:
            return err
        if per_frame:
            return torch.mean(err, dim=(2, 3))
        return torch.mean(err, dim=(1, 2, 3))

    def reconstruction_error(self, x: torch.Tensor, per_frame: bool = False,
                             per_pixel: bool = False) -> torch.Tensor:
        """Scores at sequence ``[B]``, frame ``[B,T]`` or pixel
        ``[B,T,H,W]`` granularity."""
        err = self.error_map(x)
        if per_pixel:
            return err
        if per_frame:
            return torch.mean(err, dim=(2, 3))
        return torch.mean(err, dim=(1, 2, 3))


XAVIER_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def init_training_weights(model: nn.Module, seed: int) -> nn.Module:
    """The JAX model's initialization, drawn from a seeded CPU generator
    (other numbers than ``jax.random``, the same distribution): every conv
    kernel Xavier-normal truncated at two standard deviations (Flax's
    ``xavier_normal``, fans of the Flax kernel: a ConvLSTM layer's
    ``w_x``/``w_h`` share the fused ``[3,3,I+H,4H]`` kernel's), biases 0,
    norm scales 1, running statistics (0, 1).  Serves both model families
    (``models/autoencoder.ConvAutoencoder`` too)."""
    gen = torch.Generator().manual_seed(seed)
    norm_scales = {f"{name}.weight" for name, m in model.named_modules()
                   if isinstance(m, (nn.BatchNorm2d, nn.GroupNorm))}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() < 2:
                p.fill_(1.0 if name in norm_scales else 0.0)
                continue
            if name.endswith(("w_x", "w_h")):
                layer = model.convlstm.layers[int(name.split(".")[2])]
                fan_in = 9 * (layer.input_dim + layer.hidden_dim)
                fan_out = 9 * 4 * layer.hidden_dim
            else:  # OIHW conv or IOHW ConvTranspose: the fan sum is the same
                receptive = p[0, 0].numel()
                fan_in, fan_out = p.shape[1] * receptive, p.shape[0] * receptive
            std = math.sqrt(2.0 / (fan_in + fan_out)) / XAVIER_TRUNC_STD
            value = torch.empty(p.shape)
            nn.init.trunc_normal_(value, std=std, a=-2 * std, b=2 * std, generator=gen)
            p.copy_(value)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.zero_()
            elif name.endswith("running_var"):
                buf.fill_(1.0)
    return model


def init_weights(model: VideoAutoencoder, seed: int) -> VideoAutoencoder:
    """Draw every weight from a seeded ``torch.Generator`` on the CPU (so the
    values do not depend on the device): Xavier-normal conv kernels, small
    biases, and BatchNorm affine/running statistics away from identity so
    a folded first block is exercised for real."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2:
                receptive = p[0, 0].numel() if p.dim() == 4 else 1
                if name.endswith("w_h"):  # HWIO
                    fan_in, fan_out = 9 * p.shape[2], 9 * p.shape[3]
                else:
                    fan_in, fan_out = p.shape[1] * receptive, p.shape[0] * receptive
                std = math.sqrt(2.0 / (fan_in + fan_out))
                value = torch.randn(p.shape, generator=gen) * std
            elif name.endswith("weight"):  # norm scale
                value = 1.0 + 0.1 * torch.randn(p.shape, generator=gen)
            else:
                value = 0.05 * torch.randn(p.shape, generator=gen)
            p.copy_(value)
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.05 * torch.randn(buf.shape, generator=gen))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
    return model
