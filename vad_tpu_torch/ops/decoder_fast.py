"""Matmul reformulation of the video decoder (the JAX package's
``vad_tpu/ops/decoder_fast.py``), behind ``VideoAutoencoder.stream_step_fast``.

The decoder is four ConvTranspose(2x2, stride 2) layers.  With kernel ==
stride no taps overlap, so each layer is a per-pixel dense product ``C_in
-> 4*C_out`` whose four output blocks are the 2x2 sub-pixels; kept in
"quadtree" row order (base pixel, then one (py, px) bit pair per layer),
the depth-to-space between layers is a free row-major reshape, so the
whole decoder is four ``torch.matmul``s with inference BatchNorm folded in.
Frame scores are order-invariant reductions: they compare against
``quadtree_view(x)``; full frames pay one ``raster_from_quadtree``.

The JAX package computes this in plain ``jnp`` outside any Pallas kernel,
so the port's products are library calls.  On the v5e the JAX version
lost 39% end to end to ``stream_step`` (its TPU relayouts: a lane-dim
reshape per layer, ``[N, 3]`` rows padded 42x); on the H100 ``[R, 4C] ->
[4R, C]`` is a view of contiguous memory.  It is not wired into serving.

Quadtree row order after L layers over a ``[F, s, s, C]`` latent: rows =
``(f, h0, w0, py1, px1, ..., pyL, pxL)`` with ``h = ((h0*2+py1)*2+py2)...``.

Flax's ConvTranspose(2x2, s2, VALID) enters the kernel spatially flipped:
``y[2h+py, 2w+px, co] = sum_ci x[h, w, ci] * K[1-py, 1-px, ci, co]``; the
fold reads the JAX package's variables tree and bakes that in (the port's
``ConvTranspose2d`` weight is the same kernel flipped, ``utils/weights.py``).
GroupNorm's per-sample statistics do not fold into a constant product, so
this path needs ``norm='batch'``.
"""

from __future__ import annotations

from typing import List, Mapping, Sequence, Tuple

import numpy as np
import torch

BN_EPS = 1e-5

__all__ = ["fold_decoder_params", "decode_quadtree", "quadtree_view", "raster_from_quadtree"]


def fold_decoder_params(variables: Mapping, dtype: torch.dtype = torch.bfloat16,
                        device=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Fold the decoder's ConvTranspose + inference-BatchNorm stack of a
    JAX-layout variables tree (``utils/weights.state_dict_to_flax`` of a
    port model, or a ``.ckpt``'s) into per-layer ``(W2 [C_in, 4*C_out] in
    dtype, b2 [4*C_out] f32)`` on ``device`` (default: the CPU).

    Column order of each W2 is (py, px, c_out): a row-major reshape of the
    output to ``[rows*4, C_out]`` appends the (py, px) bits to the row
    index.  Raises ValueError for norm='group' models."""
    params = variables["params"]["decoder"]
    if "BatchNorm_0" not in params:
        raise ValueError("fast decoder folds inference BatchNorm into the matmuls; this "
                         "model was built with norm='group' — use the standard path")
    stats = variables["batch_stats"]["decoder"]
    layers = []
    for i in range(4):
        k = np.asarray(params[f"ConvTranspose_{i}"]["kernel"], np.float32)  # [2,2,ci,co]
        b = np.asarray(params[f"ConvTranspose_{i}"]["bias"], np.float32)
        ci, co = k.shape[2], k.shape[3]
        # flipped-kernel semantics: output sub-pixel (py, px) reads K[1-py, 1-px]
        w2 = k[::-1, ::-1].transpose(2, 0, 1, 3).reshape(ci, 4 * co).copy()
        b2 = np.tile(b, 4)
        if i < 3:  # BN + ReLU layers; the last layer is tanh, no norm
            bn, st = params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"]
            inv = 1.0 / np.sqrt(np.asarray(st["var"], np.float32) + BN_EPS)
            sc = np.asarray(bn["scale"], np.float32) * inv
            sh = np.asarray(bn["bias"], np.float32) - np.asarray(st["mean"], np.float32) * sc
            w2 = w2 * np.tile(sc, 4)
            b2 = b2 * np.tile(sc, 4) + np.tile(sh, 4)
        layers.append((torch.as_tensor(w2, dtype=dtype, device=device),
                       torch.as_tensor(b2, dtype=torch.float32, device=device)))
    return layers


def decode_quadtree(z: torch.Tensor, folded: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                    ) -> torch.Tensor:
    """The folded decoder on latents ``z [..., s, s, C]``: reconstruction
    rows in quadtree order, ``[prod(batch)*s*s*4**L, C_out]`` in z's type.
    Each product runs in W2's type and the bias is added in f32 (in bf16
    the product is rounded to bf16 before the bias, where JAX keeps it in
    f32: PyTorch's CPU products have no f32 output for bf16 operands)."""
    x = z.reshape(-1, z.shape[-1])
    n = len(folded)
    for i, (w2, b2) in enumerate(folded):
        y = torch.matmul(x.to(w2.dtype), w2).float() + b2
        y = y.reshape(-1, y.shape[-1] // 4).to(z.dtype)  # rows*4, C_out
        x = torch.relu(y) if i < n - 1 else torch.tanh(y)
    return x


def quadtree_view(x: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Raster NHWC ``[..., H, W, C]`` -> quadtree rows ``[N, C]`` in
    ``decode_quadtree``'s row order (one (py, px) bit pair per level)."""
    *batch, h, w, c = x.shape
    h0, w0 = h >> levels, w >> levels
    shape = [int(np.prod(batch) or 1), h0] + [2] * levels + [w0] + [2] * levels + [c]
    x = x.reshape(shape)
    # (B, h0, py1..pyL, w0, px1..pxL, C) -> (B, h0, w0, py1, px1, ...)
    perm = [0, 1, 2 + levels]
    for i in range(levels):
        perm += [2 + i, 3 + levels + i]
    perm.append(3 + 2 * levels)
    return x.permute(perm).reshape(-1, c)


def raster_from_quadtree(y: torch.Tensor, batch_shape, h: int, w: int,
                         levels: int = 4) -> torch.Tensor:
    """Quadtree rows ``[N, C]`` -> raster ``[*batch_shape, H, W, C]``."""
    c = y.shape[-1]
    h0, w0 = h >> levels, w >> levels
    b = int(np.prod(batch_shape) or 1)
    y = y.reshape([b, h0, w0] + [2, 2] * levels + [c])
    # (B, h0, w0, py1, px1, ...) -> (B, h0, py1..pyL, w0, px1..pxL, C)
    perm = [0, 1] + [3 + 2 * i for i in range(levels)] + [2] + [4 + 2 * i for i in range(levels)]
    perm.append(3 + 2 * levels)
    return y.permute(perm).reshape(*batch_shape, h, w, c)
