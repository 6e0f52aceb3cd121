"""Latent-distance anomaly scoring: per-position Gaussians over encoder
features (the JAX package's ``vad_tpu/eval/latent_score.py``, the PaDiM
recipe).

1. Run the frozen encoder over normal (training-split) samples and
   collect its multi-scale block outputs, resampled onto one G x G grid
   and concatenated channel-wise, optionally projected to D dims by a
   fixed seeded random matrix.
2. Fit a Gaussian per grid position: mean [P, D] and a shrinkage-
   regularized covariance [P, D, D], P = G*G, kept as its inverse.
3. Score a sample by the per-position Mahalanobis distance of its
   embedding: an anomaly map that needs no decoder.

The fit is one streaming pass that accumulates, per position, the sum and
the sum of outer products of the embeddings minus an anchor (the first
batch's mean), so the moments stay near zero mean and E[ee^T] - mu mu^T
does not cancel; every product runs in true f32 (TF32 off on the card,
``utils/precision.tf32_off``).  The Cholesky factorization and solve
(``torch.linalg.cholesky``, ``torch.cholesky_solve``) run once, at the end.

Interfaces follow the JAX module: ``pyramid_fn(variables, x)`` maps a
batch to a feature pyramid (one map per encoder block), and ``variables`` is whatever
it takes (here, typically, the model).  Where the JAX module pads a short
tail batch to one compiled shape and masks it, this one runs eagerly and
takes batches of any size.

The one difference by design is the projection: ``make_projection`` draws
from a seeded ``torch.Generator`` on the CPU, scaled by 1/sqrt(D) as JAX
does, but not JAX's bits.  The stats file carries ``proj``, so a fit from
either package scores in the other, and ``fit_latent_stats(proj=...)``
fits with a given projection (JAX's, for a comparison).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vad_tpu_torch.utils.precision import tf32_off

PyramidFn = Callable[..., Tuple[torch.Tensor, ...]]

DEFAULT_LAYERS = (0, 1, 2)  # skip the most abstract block by default
DEFAULT_PROJ_DIM = 128
DEFAULT_SHRINK = 0.01
DEFAULT_MAX_GRID = 32


@dataclasses.dataclass
class LatentStats:
    """Fitted per-position Gaussian statistics (f32 tensors)."""

    mean: torch.Tensor  # [P, D]
    precision: torch.Tensor  # [P, D, D] inverse covariance
    proj: Optional[torch.Tensor]  # [C, D] fixed random projection (or None)
    grid: int  # G (maps are [N, G, G])
    layers: Tuple[int, ...]
    n_fit: int  # embeddings the fit saw

    @property
    def dim(self) -> int:
        return int(self.mean.shape[-1])


def _resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear resize with half-pixel centres, antialiased when it
    shrinks: ``jax.image.resize(..., "linear")``'s weights, edges included."""
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=True)


def _resample(f: torch.Tensor, grid: int) -> torch.Tensor:
    """``[N, h, w, c]`` -> ``[N, grid, grid, c]``.

    Finer layers average-pool down (exact when h % grid == 0), coarser
    layers nearest-repeat up; a non-integer ratio (odd input sizes) falls
    back to the bilinear resize."""
    h = f.shape[1]
    if h == grid:
        return f
    if h > grid and h % grid == 0:
        return F.avg_pool2d(f.permute(0, 3, 1, 2), h // grid).permute(0, 2, 3, 1)
    if h < grid and grid % h == 0:
        k = grid // h
        return f.repeat_interleave(k, dim=1).repeat_interleave(k, dim=2)
    return _resize_bilinear(f.permute(0, 3, 1, 2), (grid, grid)).permute(0, 2, 3, 1)


def pyramid_embed(feats: Sequence[torch.Tensor], layers: Sequence[int], grid: int,
                  proj: Optional[torch.Tensor]) -> torch.Tensor:
    """Selected pyramid levels -> per-position embeddings ``[N, P, D]``."""
    e = torch.cat([_resample(feats[i].float(), grid) for i in layers], dim=-1)
    e = e.reshape(e.shape[0], grid * grid, e.shape[-1])  # [N, P, C]
    return e if proj is None else e @ proj


def default_grid(feats: Sequence[torch.Tensor], layers: Sequence[int]) -> int:
    """The middle selected layer's spatial size, capped at
    ``DEFAULT_MAX_GRID`` (grid G costs G^2 * D^2 floats of precision)."""
    sizes = sorted(int(feats[i].shape[1]) for i in layers)
    return min(sizes[len(sizes) // 2], DEFAULT_MAX_GRID)


def make_projection(n_channels: int, proj_dim: Optional[int],
                    seed: int) -> Optional[torch.Tensor]:
    """Fixed Gaussian random projection ``[C, D]`` scaled by 1/sqrt(D),
    drawn from a seeded CPU generator (deterministic for a seed; not JAX's
    numbers); None when no reduction is needed."""
    if proj_dim is None or proj_dim >= n_channels:
        return None
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn((n_channels, proj_dim), generator=gen, dtype=torch.float32)
    return w / math.sqrt(proj_dim)


def _as_tensor(batch) -> torch.Tensor:
    return batch if isinstance(batch, torch.Tensor) else torch.from_numpy(np.asarray(batch))


def fit_latent_stats(
    pyramid_fn: PyramidFn,
    variables,
    batches: Iterable,
    *,
    layers: Sequence[int] = DEFAULT_LAYERS,
    grid: Optional[int] = None,
    proj_dim: Optional[int] = DEFAULT_PROJ_DIM,
    shrink: float = DEFAULT_SHRINK,
    seed: int = 0,
    proj: Optional[torch.Tensor] = None,
) -> LatentStats:
    """One streaming pass over normal samples -> ``LatentStats``.

    ``pyramid_fn(variables, x)`` maps a batch (a tensor, or a numpy array,
    which goes in as a CPU tensor) to the feature pyramid; it may expand
    samples (windows -> frames), and ``n_fit`` counts embeddings.  The
    statistics live on the pyramid's device.  ``proj`` (the one argument
    the JAX function lacks) fits with that projection instead of
    ``make_projection(C, proj_dim, seed)``."""
    layers = tuple(int(i) for i in layers)
    it = iter(batches)
    first = next(it, None)
    if first is None:
        raise ValueError("fit_latent_stats needs at least one batch")
    with torch.no_grad(), tf32_off():
        feats = pyramid_fn(variables, _as_tensor(first))
        if max(layers) >= len(feats):
            raise ValueError(f"layers {layers} out of range for a {len(feats)}-level pyramid")
        g = int(grid) if grid else default_grid(feats, layers)
        n_channels = sum(int(feats[i].shape[-1]) for i in layers)
        if proj is None:
            proj = make_projection(n_channels, proj_dim, seed)
        dev = feats[0].device
        if proj is not None:
            proj = torch.as_tensor(proj, dtype=torch.float32).to(dev)
        d = int(proj.shape[1]) if proj is not None else n_channels
        count = 0
        s1 = torch.zeros((g * g, d), dtype=torch.float32, device=dev)
        s2 = torch.zeros((g * g, d, d), dtype=torch.float32, device=dev)
        anchor = None
        while feats is not None:
            e = pyramid_embed(feats, layers, g, proj)  # [N, P, D]
            if anchor is None:
                anchor = e.mean(dim=0)
            e = (e - anchor).transpose(0, 1)  # [P, N, D]
            count += e.shape[1]
            s1 += e.sum(dim=1)
            s2.baddbmm_(e.transpose(1, 2), e)
            batch = next(it, None)
            feats = None if batch is None else pyramid_fn(variables, _as_tensor(batch))
        mean, precision = _finalize(count, s1, s2, anchor, shrink)
    return LatentStats(mean=mean, precision=precision, proj=proj, grid=g, layers=layers,
                       n_fit=count)


def _finalize(count: int, s1: torch.Tensor, s2: torch.Tensor, anchor: torch.Tensor,
              shrink: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, precision) from the anchored moments: the unbiased
    covariance, shrunk toward a scaled identity (``shrink`` times the mean
    variance + 1e-6 on the diagonal, so every position inverts even when
    n_fit < D), inverted through its Cholesky factor."""
    n = torch.tensor(float(count), dtype=torch.float32, device=s1.device)
    delta = s1 / n  # residual mean after anchoring (near zero)
    cov = s2 / n - delta[:, :, None] * delta[:, None, :]
    cov = cov * (n / torch.clamp_min(n - 1.0, 1.0))
    d = cov.shape[-1]
    diag_mean = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1) / d
    eye = torch.eye(d, dtype=torch.float32, device=cov.device)
    cov = cov + (shrink * diag_mean + 1e-6)[:, None, None] * eye
    chol = torch.linalg.cholesky(cov)
    return anchor + delta, torch.cholesky_solve(eye.expand_as(cov), chol)


def stats_state(stats: LatentStats, device=None):
    """The fitted arrays ``(mean, precision, proj)`` that ``make_distance_fn``'s
    function takes, moved to ``device`` once (the precision is 67 MB at the
    image defaults)."""
    move = (lambda t: t) if device is None else (lambda t: t.to(device))
    return (move(stats.mean), move(stats.precision),
            None if stats.proj is None else move(stats.proj))


def make_distance_fn(pyramid_fn: PyramidFn, layers, grid: int):
    """``fn(variables, state, x) -> [N, G, G]`` Mahalanobis distances, with
    ``state`` from ``stats_state``.  N comes from the embedding, so a
    ``pyramid_fn`` that expands samples gives a map per expanded sample."""
    layers = tuple(int(i) for i in layers)
    g = int(grid)

    def fn(v, state, x):
        mean, precision, proj = state
        with torch.no_grad(), tf32_off():
            e = (pyramid_embed(pyramid_fn(v, x), layers, g, proj) - mean).transpose(0, 1)
            d2 = ((e @ precision) * e).sum(dim=-1).transpose(0, 1)  # [N, P]
            return torch.sqrt(torch.clamp_min(d2, 0.0)).reshape(-1, g, g)

    return fn


def make_distance_step(pyramid_fn: PyramidFn, stats: LatentStats):
    """``step(variables, x)``: ``make_distance_fn`` with the statistics
    bound in."""
    fn = make_distance_fn(pyramid_fn, stats.layers, stats.grid)
    state = stats_state(stats)
    return lambda v, x: fn(v, state, x)


def upsample_maps(maps: torch.Tensor, size: int) -> torch.Tensor:
    """``[N, G, G]`` -> ``[N, size, size]`` bilinear, for pixel-level metrics."""
    return _resize_bilinear(maps[:, None], (size, size))[:, 0]


def fit_or_load(pyramid_fn: PyramidFn, variables, batches: Iterable, *, save_path=None,
                load_path=None, what: str = "samples", **fit_kwargs) -> LatentStats:
    """Load persisted stats (``load_path``) or fit and persist them
    (``save_path``), printing the one-line summary both CLIs show.  ``what``
    names the fit unit ('images' / 'frames')."""
    if load_path is not None:
        stats = load_stats(load_path)
        print(f"  loaded latent stats: grid {stats.grid}x{stats.grid}, "
              f"embedding dim {stats.dim}, fitted on {stats.n_fit} {what} ({load_path})")
        return stats
    stats = fit_latent_stats(pyramid_fn, variables, batches, **fit_kwargs)
    suffix = ""
    if save_path is not None:
        save_stats(save_path, stats)
        suffix = f" (stats -> {getattr(save_path, 'name', save_path)})"
    print(f"  grid {stats.grid}x{stats.grid}, embedding dim {stats.dim}, "
          f"fit on {stats.n_fit} {what}{suffix}")
    return stats


def save_stats(path, stats: LatentStats) -> None:
    """Persist fitted stats as the JAX package's npz (same keys and dtypes),
    so ``--latent-stats`` reads a file from either package."""
    host = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    np.savez_compressed(
        path,
        mean=host(stats.mean),
        precision=host(stats.precision),
        proj=(host(stats.proj) if stats.proj is not None else np.zeros(0)),
        grid=stats.grid,
        layers=np.asarray(stats.layers),
        n_fit=stats.n_fit,
    )


def load_stats(path) -> LatentStats:
    """A stats npz of either package, as CPU tensors."""
    z = np.load(path)
    proj = z["proj"]
    as_f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return LatentStats(
        mean=as_f32(z["mean"]),
        precision=as_f32(z["precision"]),
        proj=(as_f32(proj) if proj.size else None),
        grid=int(z["grid"]),
        layers=tuple(int(i) for i in z["layers"]),
        n_fit=int(z["n_fit"]),
    )
