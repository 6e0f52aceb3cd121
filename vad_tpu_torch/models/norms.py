"""Normalization-layer selection (the JAX package's ``make_norm``).

'batch' is Flax's ``nn.BatchNorm(momentum=0.9)``, eps 1e-5.  In eval mode
it normalizes with the running statistics (``nn.BatchNorm2d``'s own
inference path).  In train mode it follows Flax, not torch: the batch mean
and the *biased* batch variance (E[x^2] - E[x]^2, clipped at 0), reduced in
f32 whatever the input type; the running statistics move as 0.9·old +
0.1·batch, the biased variance included (torch would store the unbiased
one); the output comes back in the type of the input and the affine
parameters, as Flax returns it.

With a ``mesh`` set (``parallel.sharding.distribute``) train mode sums
``sum(x)``, ``sum(x^2)`` and the count over the mesh's data group (one
``all_reduce``, whose backward is an ``all_reduce`` of the gradients), so
every rank normalizes by the GLOBAL batch's statistics in the same one-pass
form: what the batch mean over a sharded batch is under GSPMD.  Without
one it is the exact single-process computation.  (``SyncBatchNorm`` keeps
the unbiased running variance and two-pass statistics: not Flax's layer.)

'group' is GroupNorm(8) with eps 1e-6, Flax's default: torch's own default
(1e-5) would shift outputs wherever a group's variance is small.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

NORM_KINDS = ("batch", "group")
BATCH_NORM_EPS = 1e-5
BATCH_NORM_MOMENTUM = 0.9  # Flax's: weight of the old running value
GROUP_NORM_EPS = 1e-6
GROUP_NORM_GROUPS = 8  # divides every channel width both model families use


class _SumOverGroup(torch.autograd.Function):
    """``all_reduce`` SUM over a group; its backward sums the gradients the
    same way (every rank's loss depends on the shared sum)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return None, grad


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (NCHW, any memory format) with Flax's train mode."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=BATCH_NORM_EPS, momentum=1.0 - BATCH_NORM_MOMENTUM)
        self.mesh = None  # set by parallel.sharding.distribute

    def _global_moments(self, xf: torch.Tensor):
        """(mean, E[x^2]) over the data group's global batch."""
        count = torch.tensor([xf.numel() / xf.shape[1]], dtype=xf.dtype, device=xf.device)
        local = torch.cat([xf.sum(dim=(0, 2, 3)), torch.square(xf).sum(dim=(0, 2, 3)), count])
        total = _SumOverGroup.apply(self.mesh.data_group, local)
        c = xf.shape[1]
        n = total[2 * c].detach()
        return total[:c] / n, total[c:2 * c] / n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # f32 at least, as Flax
        if self.mesh is not None:
            mean, mean_sq = self._global_moments(xf)
        else:
            mean, mean_sq = xf.mean(dim=(0, 2, 3)), torch.square(xf).mean(dim=(0, 2, 3))
        var = torch.clamp_min(mean_sq - torch.square(mean), 0.0)
        with torch.no_grad():
            self.running_mean.mul_(BATCH_NORM_MOMENTUM).add_(mean, alpha=1.0 - BATCH_NORM_MOMENTUM)
            self.running_var.mul_(BATCH_NORM_MOMENTUM).add_(var, alpha=1.0 - BATCH_NORM_MOMENTUM)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias.to(xf.dtype)[:, None, None]
        dtype = torch.promote_types(x.dtype, torch.promote_types(self.weight.dtype,
                                                                 self.bias.dtype))
        return y.to(dtype)


def make_norm(kind: str, channels: int) -> nn.Module:
    """One normalization layer over ``channels`` (NCHW, any memory format)."""
    if kind == "batch":
        return BatchNorm(channels)
    if kind == "group":
        return nn.GroupNorm(GROUP_NORM_GROUPS, channels, eps=GROUP_NORM_EPS)
    raise ValueError(f"unknown norm {kind!r}; expected one of {NORM_KINDS}")
