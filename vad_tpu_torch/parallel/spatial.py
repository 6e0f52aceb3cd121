"""The spatial row split: both models' scoring forward over row shards of
each frame, with every halo exchange written out.

The JAX package splits the image rows over the mesh's 'model' axis and lets
XLA's SPMD partitioner insert the exchanges (``MultiStreamScorer(spatial=
True)``, ``ImageScoringService(spatial=True)``); there is no counterpart
module there.  Here a frame batch is a list of row shards, shard j holding
rows ``spatial_frame_sharding(mesh, H)[j]`` on its own device with its own
model copy, and each layer is the unsplit layer with its exchange:

- a 3x3 SAME conv concatenates one neighbour row above and below each
  shard (``halo_rows``: zeros at the frame's edges) and convolves with
  ``padding=(0, 1)``;
- the stride-2 stem's conv (``stem='stride2'``) pads JAX's SAME (0, 1), so
  a shard of even rows needs only the row below;
- GroupNorm adds its per-sample group sums over the shards before it
  normalizes (``norm='group'``);
- inference BatchNorm, the 2x2 max-pool (shards of even rows),
  ConvTranspose 2x2/2, the activations and the 1x1 projection need none;
- the ConvLSTM's hoisted input conv is a 3x3 SAME conv, and its recurrence
  is kernel 1's row form (``ops/convlstm.convlstm_recurrence_rows``), which
  exchanges the boundary rows of h at every step;
- the frame score is the sum of the shards' row sums of the error map over
  ``H*W``.

``RowSplit`` walks the same submodules, weights and order of operations as
the unsplit ``stream_step`` and ``reconstruction_error``, so the two read
alike; the models must be in eval mode (the scoring calls).
"""

from __future__ import annotations

import copy
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vad_tpu_torch.ops.convlstm import convlstm_recurrence_rows
from vad_tpu_torch.parallel.sharding import MODEL_AXIS, Mesh

NEGATIVE_SLOPE = 0.2  # the models' LeakyReLU


def replicate_grid(model: nn.Module, mesh: Mesh) -> List[List[nn.Module]]:
    """One model copy per cell of ``mesh``'s grid (a device may repeat):
    ``copies[i][j]`` on ``mesh.devices[i, j]``; the first is ``model``
    itself when it already lives on the first device."""
    first = next(model.parameters()).device
    grid = []
    for i in range(mesh.devices.shape[0]):
        row = []
        for j in range(mesh.shape[MODEL_AXIS]):
            dev = mesh.devices[i, j]
            same = i == 0 and j == 0 and first == dev
            row.append(model if same else copy.deepcopy(model).to(dev))
        grid.append(row)
    return grid


def halo_rows(shards: Sequence[torch.Tensor], dim: int = 2) -> List[Tuple[torch.Tensor,
                                                                          torch.Tensor]]:
    """``(above, below)`` of each row shard: the neighbour shards' boundary
    rows along ``dim`` (one row each), copied to the shard's device, and
    zeros at the frame's top and bottom."""
    out = []
    n = len(shards)
    for j, y in enumerate(shards):
        edge = torch.zeros_like(y.narrow(dim, 0, 1))
        above = shards[j - 1].narrow(dim, shards[j - 1].shape[dim] - 1, 1).to(y.device) \
            if j > 0 else edge
        below = shards[j + 1].narrow(dim, 0, 1).to(y.device) if j < n - 1 else edge
        out.append((above, below))
    return out


def conv3x3_same(ys: Sequence[torch.Tensor], weights: Sequence[torch.Tensor],
                 biases: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
    """A 3x3 stride-1 SAME conv over NCHW row shards (each shard's own
    weight copy): each shard with its halo rows, ``padding=(0, 1)``."""
    return [F.conv2d(torch.cat([above, y, below], dim=2), w, b, padding=(0, 1))
            for y, (above, below), w, b in zip(ys, halo_rows(ys), weights, biases)]


def conv3x3_stride2(ys: Sequence[torch.Tensor], convs: Sequence[nn.Conv2d]) -> List[torch.Tensor]:
    """The stride-2 stem's 3x3 conv under JAX's SAME padding (0, 1) of even
    sizes, over NCHW row shards of even rows: each shard takes the row
    below it (zeros under the frame) and one zero column on the right."""
    out = []
    for y, (_, below), conv in zip(ys, halo_rows(ys), convs):
        padded = F.pad(torch.cat([y, below], dim=2), (0, 1))
        out.append(F.conv2d(padded, conv.weight, conv.bias, stride=2))
    return out


def group_norm(ys: Sequence[torch.Tensor], norms: Sequence[nn.GroupNorm]) -> List[torch.Tensor]:
    """GroupNorm over NCHW row shards: each sample's group mean from the
    shards' summed sums, then its variance from their summed squared
    deviations (two passes, in f32 at least), on the first shard's device;
    each shard normalized with its own affine copy, in its input's type."""
    g = norms[0].num_groups
    main = ys[0].device
    acc = torch.promote_types(ys[0].dtype, torch.float32)

    def grouped(y):
        n, c, h, w = y.shape
        return y.to(acc).reshape(n, g, c // g, h, w)

    count = sum(y[0].numel() for y in ys) // g
    total = sum(grouped(y).sum(dim=(2, 3, 4)).to(main) for y in ys)
    mean = total / count
    sq = sum(torch.square(grouped(y) - mean.to(y.device)[:, :, None, None, None])
             .sum(dim=(2, 3, 4)).to(main) for y in ys)
    inv = torch.rsqrt(sq / count + norms[0].eps)
    out = []
    for y, norm in zip(ys, norms):
        n, c, h, w = y.shape
        z = (grouped(y) - mean.to(y.device)[:, :, None, None, None]) \
            * inv.to(y.device)[:, :, None, None, None]
        z = z.reshape(n, c, h, w) * norm.weight.to(acc)[:, None, None] \
            + norm.bias.to(acc)[:, None, None]
        out.append(z.to(y.dtype))
    return out


class RowSplit:
    """The scoring forward of one model's row-split copies: ``models[j]``
    holds row shard j (on its device, in eval mode)."""

    def __init__(self, models: Sequence[nn.Module]) -> None:
        self.models = list(models)
        self.norm = models[0].norm
        self.devices = [next(m.parameters()).device for m in self.models]
        self.device = self.devices[0]  # where results gather

    def each(self, get: Callable[[nn.Module], nn.Module]) -> List[nn.Module]:
        """The same submodule of every copy, in shard order."""
        return [get(m) for m in self.models]

    @staticmethod
    def map(fn: Callable, ys: Sequence[torch.Tensor], mods: Optional[Sequence] = None):
        if mods is None:
            return [fn(y) for y in ys]
        return [fn(m, y) for m, y in zip(mods, ys)]

    def conv(self, ys, get) -> List[torch.Tensor]:
        convs = self.each(get)
        return conv3x3_same(ys, [c.weight for c in convs], [c.bias for c in convs])

    def normalize(self, ys, get) -> List[torch.Tensor]:
        norms = self.each(get)
        if self.norm == "group":
            return group_norm(ys, norms)
        return [norm(y) for norm, y in zip(norms, ys)]

    # ------------------------------------------------------- video model

    def video_encoder(self, ys: List[torch.Tensor]) -> List[torch.Tensor]:
        """``VideoEncoder.forward`` over NCHW frame shards ``[B*T, 3, Hs, W]``."""
        enc = self.models[0].encoder
        for k in range(len(enc.convs)):
            if enc.stem == "stride2":
                ys = conv3x3_stride2(ys, self.each(lambda m: m.encoder.convs[k]))
            else:
                ys = self.conv(ys, lambda m: m.encoder.convs[k])
            ys = self.normalize(ys, lambda m: m.encoder.norms[k])
            if enc.stem == "pool":
                ys = self.map(lambda y: F.max_pool2d(y, 2), ys)
            ys = self.map(lambda y: F.leaky_relu(y, NEGATIVE_SLOPE), ys)
        return ys

    def convlstm(self, zs: List[torch.Tensor], states) -> Tuple[List[torch.Tensor], list]:
        """Every ConvLSTM layer over latent shards ``[B,T,hs,w,I]`` from the
        per-shard carried ``states[j]`` (a (h, c) per layer): the hoisted
        input conv with its halo, then kernel 1's row form.  Returns the
        last layer's hidden shards and each shard's new states."""
        b, t = zs[0].shape[:2]
        layers = self.models[0].convlstm.layers
        finals = [[] for _ in zs]
        for k, layer in enumerate(layers):
            copies = self.each(lambda m: m.convlstm.layers[k])
            flat = [z.reshape(b * t, *z.shape[2:]).permute(0, 3, 1, 2) for z in zs]
            gates = conv3x3_same(flat, [c.w_x for c in copies], [c.bias for c in copies])
            gates_x = [g.permute(0, 2, 3, 1).reshape(b, t, g.shape[2], g.shape[3], -1)
                       for g in gates]
            h0 = [st[k][0].float() for st in states]
            c0 = [st[k][1].float() for st in states]
            zs, new = convlstm_recurrence_rows(gates_x, [c.w_h for c in copies], h0, c0)
            for j, state in enumerate(new):
                finals[j].append(state)
        return zs, [tuple(f) for f in finals]

    def video_decoder(self, zs: List[torch.Tensor]) -> List[torch.Tensor]:
        """``VideoDecoder.forward`` over NCHW latent shards."""
        dec = self.models[0].decoder
        ys = zs
        for k in range(len(dec.norms)):
            ys = self.map(lambda m, y: m.decoder.deconvs[k](y), ys, self.models)
            ys = self.normalize(ys, lambda m: m.decoder.norms[k])
            ys = self.map(F.relu, ys)
        last = len(dec.deconvs) - 1
        return self.map(lambda m, y: torch.tanh(m.decoder.deconvs[last](y)), ys, self.models)

    def stream_step(self, xs: List[torch.Tensor], states):
        """``VideoAutoencoder.stream_step`` over frame shards ``xs[j]
        [B,T,Hs,W,C]`` (on shard j's device) from the carried ``states[j]``.
        Returns ``(reconstruction shards [B,T,Hs,W,C], error map shards
        [B,T,Hs,W], frame scores [B,T] on the first shard's device, new
        states per shard)``."""
        b, t, _, wid, ch = xs[0].shape
        height = sum(x.shape[2] for x in xs)
        flat = [x.reshape(b * t, *x.shape[2:]).permute(0, 3, 1, 2) for x in xs]
        zs = [y.permute(0, 2, 3, 1).contiguous() for y in self.video_encoder(flat)]
        zs = [z.reshape(b, t, *z.shape[1:]) for z in zs]
        zs, new_states = self.convlstm(zs, states)
        model = self.models[0]
        lat = [z.reshape(b * t, *z.shape[2:]).permute(0, 3, 1, 2) for z in zs]
        if model.proj is not None:
            lat = self.map(lambda m, y: m.proj(y), lat, self.models)
        recon = [y.permute(0, 2, 3, 1).contiguous().reshape(b, t, -1, wid, ch)
                 for y in self.video_decoder(lat)]
        errs = [torch.mean(torch.square(x - r), dim=-1) for x, r in zip(xs, recon)]
        return recon, errs, self.frame_scores(errs, height * wid), new_states

    # ------------------------------------------------------- image model

    def image_encoder(self, ys: List[torch.Tensor]) -> List[torch.Tensor]:
        """``Encoder.forward`` of the image model over NCHW shards."""
        for k, block in enumerate(self.models[0].encoder.blocks):
            if block.stem == "stride2":
                ys = conv3x3_stride2(ys, self.each(lambda m: m.encoder.blocks[k].conv1))
            else:
                ys = self.conv(ys, lambda m: m.encoder.blocks[k].conv1)
            ys = self.normalize(ys, lambda m: m.encoder.blocks[k].norm1)
            ys = self.map(lambda y: F.leaky_relu(y, NEGATIVE_SLOPE), ys)
            ys = self.conv(ys, lambda m: m.encoder.blocks[k].conv2)
            ys = self.normalize(ys, lambda m: m.encoder.blocks[k].norm2)
            if block.stem == "pool":
                ys = self.map(lambda y: F.max_pool2d(y, 2), ys)
            ys = self.map(lambda y: F.leaky_relu(y, NEGATIVE_SLOPE), ys)
        return ys

    def image_decoder(self, ys: List[torch.Tensor]) -> List[torch.Tensor]:
        """``Decoder.forward`` of the image model over NCHW shards."""
        for k in range(len(self.models[0].decoder.blocks)):
            ys = self.map(lambda m, y: m.decoder.blocks[k].deconv(y), ys, self.models)
            ys = self.map(F.relu, self.normalize(ys, lambda m: m.decoder.blocks[k].norm1))
            ys = self.conv(ys, lambda m: m.decoder.blocks[k].conv)
            ys = self.map(F.relu, self.normalize(ys, lambda m: m.decoder.blocks[k].norm2))
        ys = self.map(lambda m, y: m.decoder.deconv(y), ys, self.models)
        ys = self.map(F.relu, self.normalize(ys, lambda m: m.decoder.norm))
        return self.map(torch.tanh, self.conv(ys, lambda m: m.decoder.conv))

    def reconstruction_error(self, xs: List[torch.Tensor]) -> torch.Tensor:
        """``ConvAutoencoder.reconstruction_error`` (image scores ``[B]``, on
        the first shard's device) over NHWC image shards ``xs[j] [B,Hs,W,C]``."""
        ys = self.image_decoder(self.image_encoder([x.permute(0, 3, 1, 2) for x in xs]))
        errs = [torch.mean(torch.square(x - y.permute(0, 2, 3, 1)), dim=-1)
                for x, y in zip(xs, ys)]
        return self.frame_scores(errs, sum(x.shape[1] for x in xs) * xs[0].shape[2])

    @staticmethod
    def frame_scores(errs: Sequence[torch.Tensor], pixels: int) -> torch.Tensor:
        """The spatial mean of the error map from its row shards (the last
        two dims): the shards' row sums, in f32, added in shard order on the
        first shard's device, over ``pixels``, in the maps' type."""
        main = errs[0].device
        total = sum(e.float().sum(dim=(-2, -1)).to(main) for e in errs)
        return (total / pixels).to(errs[0].dtype)
