"""Batch renormalisation (port of phiseg_tpu/nn/normalization.py).

Equivalent of the reference `batch_renorm` (tfwrapper/normalisation.py:72-142,
Ioffe 2017): batch norm whose train-time normalisation uses the running
statistics through clipped correction factors r and d, with the clip limits
(rmax, dmax) linearly scheduled on the step from (1, 0) to (3, 5) over steps
500->4000 / 500->2500.

The statistics run in f32 (f64 for an f64 model) and the output is cast
back to the input's dtype, as the JAX module does. The running variance is
the biased batch variance, momentum .99, eps 1e-3. A self-counting int32
`steps` buffer feeds the schedule; only a training call advances it, and an
explicit `step` overrides it. Under a mesh (`set_batch_norm_mesh`) the batch
statistics are global: the sums are all-reduced over the ranks, mean first
and then the squared deviations from it, which is what jnp.mean and jnp.var
of a global array compute (parallel/mesh.py:10-11).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

RMAX_SCHEDULE = (1.0, 3.0, 500.0, 4000.0)  # (ymin, ymax, xmin, xmax)
DMAX_SCHEDULE = (0.0, 5.0, 500.0, 2500.0)


def scheduled_clip(step: torch.Tensor, y_min: float, y_max: float, x_min: float,
                   x_max: float) -> torch.Tensor:
    """The clip limit at `step`: linear from y_min at x_min to y_max at x_max."""
    y = (step.float() - x_min) * (y_max - y_min) / (x_max - x_min) + y_min
    return torch.clamp(y, y_min, y_max)


class BatchRenorm(nn.Module):
    """Batch renorm over the (N, H, W) axes of an NCHW tensor."""

    def __init__(self, features: int, momentum: float = 0.99, epsilon: float = 1e-3):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))  # Flax "scale"
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("steps", torch.zeros((), dtype=torch.int32))
        self.mesh = None  # a parallel.mesh.Mesh: global statistics in training

    def _batch_stats(self, x: torch.Tensor):
        """Per-channel batch mean and biased variance, over the ranks under a mesh."""
        axes = (0, 2, 3)
        if self.mesh is None:
            mean = x.mean(dim=axes)
            return mean, (x - mean[None, :, None, None]).square().mean(dim=axes)
        n = float(x.numel() // x.shape[1] * self.mesh.world_size)
        mean = self.mesh.all_reduce_sum(x.sum(dim=axes)) / n
        dev = (x - mean[None, :, None, None]).square().sum(dim=axes)
        return mean, self.mesh.all_reduce_sum(dev) / n

    def forward(self, x: torch.Tensor, step: Optional[torch.Tensor | int] = None) -> torch.Tensor:
        x32 = x if x.dtype == torch.float64 else x.float()
        ra_mean, ra_var = self.running_mean.to(x32.dtype), self.running_var.to(x32.dtype)

        def per_channel(t):
            return t[None, :, None, None]

        if self.training:
            mean, var = self._batch_stats(x32)
            sigma = torch.sqrt(var + self.epsilon)
            ra_sigma = torch.sqrt(ra_var + self.epsilon)
            step_t = self.steps if step is None else torch.as_tensor(step, device=x.device)
            rmax = scheduled_clip(step_t, *RMAX_SCHEDULE).to(x32.dtype)
            dmax = scheduled_clip(step_t, *DMAX_SCHEDULE).to(x32.dtype)
            r = torch.clamp(sigma / ra_sigma, 1.0 / rmax, rmax).detach()
            d = torch.clamp((mean - ra_mean) / ra_sigma, -dmax, dmax).detach()
            out = (x32 - per_channel(mean)) / per_channel(sigma) * per_channel(r) + per_channel(d)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * ra_mean + (1 - m) * mean.detach())
                self.running_var.copy_(m * ra_var + (1 - m) * var.detach())
                self.steps.add_(1)
        else:
            out = (x32 - per_channel(ra_mean)) * per_channel(torch.rsqrt(ra_var + self.epsilon))
        out = out * per_channel(self.weight.to(x32.dtype)) + per_channel(self.bias.to(x32.dtype))
        return out.to(x.dtype)
