"""Conv block, pooling and resizes (port of phiseg_tpu/nn/layers.py).

Convolutions run NCHW inside the modules; the public resize and pool
functions here take NCHW too. The dtype policy is the JAX package's
(layers.py:146-216): parameters are f32, the convolution runs in the compute
dtype, the norms run in f32 (instance norm in the convolution's dtype), and
the block's output is cast back to the compute dtype. A model made f64 (`compute_dtype="float64"` and
`model.double()`, for round-off checks) stays f64 throughout: the f32
islands widen to f64 rather than narrow (`at_least_f32`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from phiseg_tpu_torch.nn.normalization import BatchRenorm

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
    """Make every BatchNorm and BatchRenorm under `module` take its training
    statistics over the ranks of `mesh` (None: local)."""
    for m in module.modules():
        if isinstance(m, (BatchNorm, BatchRenorm)):
            m.mesh = mesh


# ---------------------------------------------------------------------------
# Weight initialisers (ref tfwrapper/utils.py:214-306; JAX layers.py:27-58)
# ---------------------------------------------------------------------------

# std of a unit normal truncated to [-2, 2]; Flax's truncated_normal
# variance scaling divides it out.
_TRUNC_STD = 0.87962566103423978


def _fans(w: torch.Tensor) -> Tuple[int, int]:
    """(fan_in, fan_out) of an OIHW kernel, as Flax counts them for HWIO."""
    receptive = w.shape[2] * w.shape[3]
    return w.shape[1] * receptive, w.shape[0] * receptive


def _variance_scaling(scale: float, mode: str, distribution: str):
    """flax.linen.initializers.variance_scaling on an OIHW kernel."""

    def init(w: torch.Tensor, generator: torch.Generator) -> None:
        fan_in, fan_out = _fans(w)
        fan = {"fan_in": fan_in, "fan_avg": (fan_in + fan_out) / 2.0}[mode]
        var = scale / fan
        with torch.no_grad():
            if distribution == "truncated_normal":
                std = math.sqrt(var) / _TRUNC_STD
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
            else:  # uniform
                limit = math.sqrt(3.0 * var)
                nn.init.uniform_(w, -limit, limit, generator=generator)

    return init


def _bilinear_upsample_init(w: torch.Tensor, generator: torch.Generator = None) -> None:
    """Bilinear-interpolation kernel on the (c, c) diagonal of an OIHW
    kernel, zeros elsewhere (ref tfwrapper/utils.py:275-306; JAX
    layers.py:27-40). Draws nothing."""
    kh, kw = w.shape[2], w.shape[3]
    fy, fx = (kh + 1) // 2, (kw + 1) // 2
    cy = fy - 1 if kh % 2 == 1 else fy - 0.5
    cx = fx - 1 if kw % 2 == 1 else fx - 0.5
    oy = torch.arange(kh, dtype=torch.float32)[:, None]
    ox = torch.arange(kw, dtype=torch.float32)[None, :]
    filt = (1 - (oy - cy).abs() / fy) * (1 - (ox - cx).abs() / fx)
    with torch.no_grad():
        w.zero_()
        for c in range(min(w.shape[0], w.shape[1])):
            w[c, c] = filt.to(w.dtype)


# Flax names in comments (JAX layers.py:45-54)
WEIGHT_INITS = {
    "he_normal": _variance_scaling(2.0, "fan_in", "truncated_normal"),  # he_normal
    "he_uniform": _variance_scaling(2.0, "fan_in", "uniform"),          # he_uniform
    "xavier_normal": _variance_scaling(1.0, "fan_avg", "truncated_normal"),  # glorot_normal
    "xavier_uniform": _variance_scaling(1.0, "fan_avg", "uniform"),     # glorot_uniform
    "caffe_uniform": _variance_scaling(1.0, "fan_in", "uniform"),
    "bilinear": _bilinear_upsample_init,
}


def get_weight_init(name: str):
    """The initialiser `name` of WEIGHT_INITS: init(w_oihw, generator) fills w in place."""
    if name not in WEIGHT_INITS:
        raise ValueError(f"unknown weight_init {name!r} (known: {sorted(WEIGHT_INITS)})")
    return WEIGHT_INITS[name]


# ---------------------------------------------------------------------------
# Conv block
# ---------------------------------------------------------------------------

NORMS = ("batch", "group", "layer", "renorm", "instance", "none")


class ConvBlock(nn.Module):
    """Conv2D + optional normalisation + activation + optional dropout
    (ref layers.py:94-145; JAX layers.py:116-216).

    SAME padding; the conv has a bias unless norm="batch" (renorm keeps it,
    as JAX's `use_bias = norm != "batch"`); the norm comes before the
    activation. The norms (ref tfwrapper/normalisation.py):

      batch     BatchNorm, momentum .99, eps 1e-3, in f32            (`bn`)
      group     max(2, C // 16) groups, eps 1e-5, per-channel affine, in f32  (`gn`)
      layer     over (C, H, W), eps 1e-3, per-channel affine, in f32 (`ln`)
      renorm    BatchRenorm, in f32, output back in the conv's dtype (`brn`)
      instance  per image and channel over (H, W), biased variance, eps 1e-5,
                x * (1 + in_scale) + in_offset, in the conv's dtype; the two
                parameters sit in the block itself, as in the Flax scope
      none      identity

    Flax's LayerNorm normalises over (H, W, C) but keeps its scale and bias
    per channel (feature_axes=-1), which F.layer_norm's own affine would make
    (C, H, W); so the affine is applied per channel here.

    `dropout_keep_prob` drops activations after the activation in training
    only, scaling the kept ones by 1/keep; its mask comes from the generator
    passed to forward. The attribute names are the Flax scope names, so a
    converted Flax tree loads by name (phiseg_tpu_torch/convert.py).
    """

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 activation: Activation = F.relu, norm: str = "none",
                 dtype: torch.dtype = torch.float32, weight_init: str = "he_normal",
                 dropout_keep_prob: Optional[float] = None):
        super().__init__()
        if norm == "batch_bf16":
            raise NotImplementedError(
                "norm 'batch_bf16' is a TPU variant the port does not carry (ROADMAP "
                "'Not to port'); use 'batch'")
        if norm not in NORMS:
            raise ValueError(f"unknown norm: {norm!r}")
        get_weight_init(weight_init)  # unknown names raise here
        self.conv = nn.Conv2d(in_features, features, kernel_size,
                              padding=kernel_size // 2, bias=norm != "batch")
        self.norm = norm
        self.weight_init = weight_init
        self.dropout_keep_prob = dropout_keep_prob
        if norm == "batch":
            self.bn = BatchNorm(features)
        elif norm == "group":
            self.gn = nn.GroupNorm(max(2, features // 16), features, eps=1e-5)
        elif norm == "layer":
            self.ln = _ChannelAffine(features)
        elif norm == "renorm":
            self.brn = BatchRenorm(features)
        elif norm == "instance":
            self.in_scale = nn.Parameter(torch.zeros(features))
            self.in_offset = nn.Parameter(torch.zeros(features))
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        w = self.conv.weight.to(self.dtype)
        b = None if self.conv.bias is None else self.conv.bias.to(self.dtype)
        x = F.conv2d(x.to(self.dtype), w, b, padding=self.conv.padding)
        x = self._normalise(x)
        if self.activation is not None:
            x = self.activation(x)
        if self.dropout_keep_prob is not None and self.training:
            if generator is None:
                raise ValueError("dropout in training needs the generator of its mask")
            keep = torch.rand(x.shape, generator=generator, device=x.device) < self.dropout_keep_prob
            x = torch.where(keep, x / self.dropout_keep_prob, torch.zeros((), dtype=x.dtype,
                                                                         device=x.device))
        return x.to(self.dtype)

    def _normalise(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm == "batch":
            return self.bn(x)
        if self.norm == "group":
            x = at_least_f32(x)
            return F.group_norm(x, self.gn.num_groups, self.gn.weight.to(x.dtype),
                                self.gn.bias.to(x.dtype), eps=self.gn.eps)
        if self.norm == "layer":
            x = at_least_f32(x)
            return self.ln(F.layer_norm(x, x.shape[1:], eps=1e-3))
        if self.norm == "renorm":
            return self.brn(x)
        if self.norm == "instance":
            mean = x.mean(dim=(2, 3), keepdim=True)
            var = x.var(dim=(2, 3), unbiased=False, keepdim=True)
            x = (x - mean) * torch.rsqrt(var + 1e-5)
            scale = self.in_scale.to(x.dtype)[None, :, None, None]
            return x * (1.0 + scale) + self.in_offset.to(x.dtype)[None, :, None, None]
        return x


class _ChannelAffine(nn.Module):
    """Per-channel scale and bias of an NCHW tensor, in its dtype (Flax
    LayerNorm's parameters with feature_axes=-1)."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight.to(x.dtype)[None, :, None, None] + \
            self.bias.to(x.dtype)[None, :, None, None]


def init_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """Flax's init for every ConvBlock under `module`, from `generator`: the
    kernel by the block's `weight_init` (he_normal by default, which in Flax
    is a normal truncated at two standard deviations), zero conv biases, and
    instance norm's in_scale from N(0, 0.02) with in_offset 0. The other
    norms keep scale 1 and bias 0, running mean 0 and variance 1."""
    for m in module.modules():
        if isinstance(m, ConvBlock):
            get_weight_init(m.weight_init)(m.conv.weight, generator)
            with torch.no_grad():
                if m.conv.bias is not None:
                    m.conv.bias.zero_()
                if m.norm == "instance":
                    nn.init.normal_(m.in_scale, std=0.02, generator=generator)
                    m.in_offset.zero_()


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> NHWC view (the JAX layout of the public outputs)."""
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view."""
    return x.permute(0, 3, 1, 2)
