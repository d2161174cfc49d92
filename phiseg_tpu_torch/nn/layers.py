"""Conv block, pooling and resizes (port of phiseg_tpu/nn/layers.py).

Convolutions run NCHW inside the modules; the public resize and pool
functions here take NCHW too. The dtype policy is the JAX package's
(layers.py:146-216): parameters are f32, the convolution runs in the compute
dtype, batch norm runs in f32, and the block's output is cast back to the
compute dtype. A model made f64 (`compute_dtype="float64"` and
`model.double()`, for round-off checks) stays f64 throughout: the f32
islands widen to f64 rather than narrow (`at_least_f32`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# Flax BatchNorm(momentum=.99, epsilon=1e-3) (layers.py:164-169): the running
# average keeps .99 of the old value, which is torch's momentum=0.01.
BN_MOMENTUM = 0.01
BN_EPS = 1e-3

Activation = Optional[Callable[[torch.Tensor], torch.Tensor]]


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """x in f32, or as it is if it is f64."""
    return x if x.dtype == torch.float64 else x.float()


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 average pooling with SAME padding (ref layers.py:44-54).

    Flax counts the SAME padding as zeros in the mean; an odd side is padded
    by one on the high edge before pooling, as flax does.
    """
    h, w = x.shape[-2], x.shape[-1]
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2))
    return F.avg_pool2d(x, 2, 2)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global average pool over the spatial dims: NCHW -> (B, C) (ref layers.py:79-81)."""
    return x.mean(dim=(2, 3))


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NCHW to (H, W) with half-pixel centres, as jax.image."""
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")


def upsample_bilinear(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Bilinear upsample of NCHW by an integer factor (ref layers.py:336-345).

    jax.image.resize samples at half-pixel centres and renormalises the
    kernel at the border, which is align_corners=False with edge clamping.
    """
    return F.interpolate(x, scale_factor=factor, mode="bilinear", align_corners=False)


def reparameterize(mu: torch.Tensor, sigma: torch.Tensor,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """z = mu + sigma * eps with eps ~ N(0, 1) in mu's dtype (layers.py:429-437).

    `eps` lets a caller inject the noise (the parity tests feed the JAX
    draws); otherwise it is drawn from `generator`.
    """
    if eps is None:
        eps = torch.randn(mu.shape, dtype=mu.dtype, device=mu.device, generator=generator)
    return mu + sigma * eps.to(mu.dtype)


class BatchNorm(nn.Module):
    """Flax-semantics batch norm over (N, H, W) of an NCHW tensor, in f32.

    Flax stores the BIASED batch variance in its running `var`; torch's
    BatchNorm2d stores the unbiased one. So this module updates its running
    statistics itself: F.batch_norm normalises with the biased variance and,
    given momentum 1 and scratch buffers, hands back the batch mean and the
    unbiased variance, which is rescaled by (n-1)/n.

    With a mesh (`set_batch_norm_mesh`), training mode is sync-BN, which is
    what BN over a global array is in JAX (parallel/mesh.py:10-11): the
    per-channel count, sum and sum of squares are all-reduced over the ranks
    (differentiably, so the backward crosses ranks too), the batch is
    normalised with Flax's biased variance E[x^2] - E[x]^2 in f32, and every
    rank updates its running statistics from the same global values.
    torch's SyncBatchNorm would store the unbiased variance.
    """

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.mesh = None  # a parallel.mesh.Mesh: sync-BN in training mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = at_least_f32(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=False, eps=BN_EPS)
        if self.mesh is not None:
            return self._sync_forward(x)
        n = x.numel() // x.shape[1]
        if n < 2:
            raise ValueError(f"batch norm in training needs > 1 value per channel, got {n}")
        batch_mean = torch.zeros_like(self.running_mean)
        batch_var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, batch_mean, batch_var, self.weight, self.bias,
                         training=True, momentum=1.0, eps=BN_EPS)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(batch_mean, alpha=BN_MOMENTUM)
            self.running_var.mul_(1.0 - BN_MOMENTUM).add_(
                batch_var * ((n - 1) / n), alpha=BN_MOMENTUM)
        return y

    def _sync_forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        local_n = x.numel() // c
        if local_n * self.mesh.world_size < 2:  # the ranks hold equal shards
            raise ValueError("batch norm in training needs > 1 value per channel")
        count = torch.full((1,), float(local_n), dtype=x.dtype, device=x.device)
        stats = self.mesh.all_reduce_sum(
            torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)), count]))
        n = stats[-1]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)  # flax clips at 0
        scale = self.weight * torch.rsqrt(var + BN_EPS)
        shift = self.bias - mean * scale
        with torch.no_grad():
            self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
            self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
        return x * scale[None, :, None, None] + shift[None, :, None, None]


def set_batch_norm_mesh(module: nn.Module, mesh) -> None:
    """Make every BatchNorm under `module` sync-BN over `mesh` (None: local)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh


class ConvBlock(nn.Module):
    """Conv2D + optional batch norm + activation (ref layers.py:94-145).

    SAME padding, no bias under batch norm, norm before the activation. The
    attribute names (`conv`, `bn`) are the Flax scope names, so a converted
    Flax tree loads by name (phiseg_tpu_torch/convert.py).
    """

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 activation: Activation = F.relu, norm: str = "none",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if norm not in ("batch", "none"):
            raise NotImplementedError(
                f"norm {norm!r} is not ported yet (ROADMAP Queue 1: the other norms); "
                "use 'batch' or 'none'"
            )
        self.conv = nn.Conv2d(in_features, features, kernel_size,
                              padding=kernel_size // 2, bias=norm != "batch")
        self.bn = BatchNorm(features) if norm == "batch" else None
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight.to(self.dtype)
        b = None if self.conv.bias is None else self.conv.bias.to(self.dtype)
        x = F.conv2d(x.to(self.dtype), w, b, padding=self.conv.padding)
        if self.bn is not None:
            x = self.bn(x)
        if self.activation is not None:
            x = self.activation(x)
        return x.to(self.dtype)


def init_he_normal_(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's default init for every ConvBlock under `module`: he_normal
    kernels, which in Flax is a normal truncated at two standard deviations
    (variance_scaling(2, fan_in, truncated_normal)), and zero biases. Batch
    norm keeps scale 1, bias 0, running mean 0 and running variance 1."""
    # std of a unit normal truncated to [-2, 2]; flax divides it out.
    trunc_std = 0.87962566103423978
    for m in module.modules():
        if isinstance(m, ConvBlock):
            w = m.conv.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            std = math.sqrt(2.0 / fan_in) / trunc_std
            with torch.no_grad():
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
                if m.conv.bias is not None:
                    m.conv.bias.zero_()


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view (the JAX layout of the public outputs)."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view."""
    return x.permute(0, 3, 1, 2)
