"""Conv blocks, residual unit, dense layer, pooling and resizes (port of
phiseg_tpu/nn/layers.py).

Convolutions run NCHW inside the modules; the public resize and pool
functions here take NCHW too, and the 3-D ones NCDHW where JAX takes NDHWC. The dtype policy is the JAX package's
(layers.py:146-216): parameters are f32, the convolution runs in the compute
dtype, the norms run in f32 (instance norm in the convolution's dtype), and
the block's output is cast back to the compute dtype. A model made f64 (`compute_dtype="float64"` and
`model.double()`, for round-off checks) stays f64 throughout: the f32
islands widen to f64 rather than narrow (`at_least_f32`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
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


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pooling with SAME padding (ref layers.py:18-28).

    Flax pads an odd side by one on the high edge with -inf; a window that
    ends past the edge (ceil_mode) takes the max of its valid pixels, which
    is the same."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Global average pool over the spatial dims: NCHW -> (B, C) (ref layers.py:79-81)."""
    return x.mean(dim=(2, 3))


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NCHW to (H, W) with half-pixel centres, as jax.image."""
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NCHW to (H, W) as jax.image.resize(..., "bilinear")
    (ref layers.py:336-345): half-pixel centres and, along a side that
    shrinks, a triangle kernel widened by the inverse scale (jax's
    antialiasing), each output's weights renormalised over the valid
    pixels. torch's antialiased bilinear computes the same weights."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=True)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest upsample of NCHW by an integer factor (ref layers.py:326-333)."""
    return resize_nearest(x, (x.shape[-2] * factor, x.shape[-1] * factor))


def upsample_bilinear(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Bilinear upsample of NCHW by an integer factor (ref layers.py:336-345).

    jax.image.resize samples at half-pixel centres and renormalises the
    kernel at the border, which is align_corners=False with edge clamping.
    """
    return F.interpolate(x, scale_factor=factor, mode="bilinear", align_corners=False)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    """jax.image's "linear" (bilinear, trilinear) kernel."""
    return (1.0 - x.abs()).clamp_min(0.0)


def resize_matrix(in_size: int, out_size: int, kernel=_triangle,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """(out_size, in_size) f32 weights W with resize(v) = W @ v along one
    axis, as jax.image.resize builds them (jax/_src/image/scale.py
    compute_weight_mat, translation 0, antialias on): sample positions at
    half-pixel centres; when the axis shrinks, the kernel widened by the
    inverse scale; each row renormalised over the input taps; rows whose
    position falls outside [-0.5, in_size - 0.5] zeroed."""
    inv_scale = 1.0 / (out_size / in_size)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    taps = torch.arange(in_size, dtype=torch.float32, device=device)
    dist = sample[:, None] - taps[None, :]
    if inv_scale > 1.0:
        dist = dist.abs() / inv_scale
    weights = kernel(dist)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[:, None], weights, torch.zeros_like(weights))


def resize_bilinear_3d(x: torch.Tensor, size: Tuple[int, int, int]) -> torch.Tensor:
    """Trilinear resize of NCDHW to (D, H, W) as jax.image.resize(...,
    "trilinear") (ref layers.py:348-358; JAX layers.py:364-367): one
    `resize_matrix` per axis that changes size, so an axis that shrinks is
    antialiased as jax.image does it, which F.interpolate's trilinear cannot.
    The weights are f32; the product is in x's dtype."""
    for axis, n in zip((2, 3, 4), size):
        if x.shape[axis] != n:
            w = resize_matrix(x.shape[axis], n, device=x.device).to(x.dtype)
            x = torch.movedim(torch.movedim(x, axis, -1) @ w.T, -1, axis)
    return x


def _nearest_index(in_size: int, out_size: int, device) -> torch.Tensor:
    """jax.image's nearest source index of each output position along one
    axis: floor((i + 0.5) * in / out), in f32 as JAX computes it."""
    pos = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * np.float32(in_size) \
        / np.float32(out_size)
    return torch.from_numpy(np.floor(pos).astype(np.int64)).to(device)


def resize_nearest_3d(x: torch.Tensor, size: Tuple[int, int, int]) -> torch.Tensor:
    """Nearest resize of NCDHW to (D, H, W) as jax.image.resize(...,
    "nearest") (ref layers.py:361-376; JAX layers.py:370-373)."""
    for axis, n in zip((2, 3, 4), size):
        if x.shape[axis] != n:
            x = x.index_select(axis, _nearest_index(x.shape[axis], n, x.device))
    return x


def upsample_bilinear_3d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Trilinear upsample of NCDHW by an integer factor (JAX layers.py:376-378)."""
    return resize_bilinear_3d(x, tuple(n * factor for n in x.shape[2:]))


def upsample_nearest_3d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest upsample of NCDHW by an integer factor (JAX layers.py:381-383)."""
    return resize_nearest_3d(x, tuple(n * factor for n in x.shape[2:]))


def avg_pool_2x2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2x2/stride-2 average pooling of NCDHW with SAME padding (JAX
    layers.py:386-388): an odd side is padded by one zero on the high edge,
    which counts in the mean, as flax's avg_pool counts it."""
    d, h, w = x.shape[-3:]
    if d % 2 or h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2, 0, d % 2))
    return F.avg_pool3d(x, 2, 2)


def max_pool_2x2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2x2/stride-2 max pooling of NCDHW with SAME padding (JAX
    layers.py:391-392): flax pads an odd side with -inf, which is ceil_mode."""
    return F.max_pool3d(x, 2, 2, ceil_mode=True)


def pad_to_size(x: torch.Tensor, target_hw: Tuple[int, int]) -> torch.Tensor:
    """Centre-pad NCHW with zeros up to (H, W), the odd pixel on the high
    edge (ref layers.py:625-650; JAX layers.py:395-402)."""
    h, w = x.shape[-2:]
    th, tw = target_hw
    if th < h or tw < w:
        raise ValueError(f"target {target_hw} smaller than input {(h, w)}")
    ph, pw = th - h, tw - w
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


def reshape_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """Space-to-depth "pooling" of NCHW (ref layers.py:57-67; JAX
    layers.py:405-410): the channels of the (even row, even column) pixels,
    then (odd, even), (even, odd), (odd, odd), the order of JAX's concat on
    NHWC's channel axis."""
    return torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                      x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=1)


# JAX's NHWC axis -> the NCHW dim that holds the same axis
_NHWC_TO_NCHW = {0: 0, 1: 2, 2: 3, 3: 1}


def crop_and_concat(tensors: Sequence[torch.Tensor], axis: int = -1) -> torch.Tensor:
    """Centre-crop NCHW tensors to the smallest (H, W) among them and
    concatenate them (ref tfwrapper/layers.py:586-622; JAX layers.py:413-427).

    `axis` is JAX's, an axis of NHWC: -1 or 3 (channels, the default) is
    NCHW's dim 1, 1 or -3 (H) dim 2, 2 or -2 (W) dim 3, 0 or -4 (batch) dim 0.
    """
    h = min(t.shape[2] for t in tensors)
    w = min(t.shape[3] for t in tensors)
    cropped = []
    for t in tensors:
        dh, dw = (t.shape[2] - h) // 2, (t.shape[3] - w) // 2
        cropped.append(t[:, :, dh:dh + h, dw:dw + w])
    return torch.cat(cropped, dim=_NHWC_TO_NCHW[axis % 4])


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
    """Flax-semantics batch norm over every dim but the channels' of an NCHW
    (or NCDHW) tensor, in f32.

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
        dims = (0,) + tuple(range(2, x.dim()))
        stats = self.mesh.all_reduce_sum(
            torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims), count]))
        n = stats[-1]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)  # flax clips at 0
        scale = self.weight * torch.rsqrt(var + BN_EPS)
        shift = self.bias - mean * scale
        with torch.no_grad():
            self.running_mean.mul_(1.0 - BN_MOMENTUM).add_(mean, alpha=BN_MOMENTUM)
            self.running_var.mul_(1.0 - BN_MOMENTUM).add_(var, alpha=BN_MOMENTUM)
        per_channel = (1, c) + (1,) * (x.dim() - 2)
        return x * scale.view(per_channel) + shift.view(per_channel)


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
    """(fan_in, fan_out) of an OIHW (or a Linear's (out, in)) kernel, as
    Flax counts them for HWIO (or (in, out))."""
    receptive = math.prod(w.shape[2:])
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

NORMS = ("batch", "batch_bf16", "group", "layer", "renorm", "instance", "none")


class _Normalised(nn.Module):
    """The norm of a conv block, applied to its conv's output by the block's
    own norm modules (the Flax scopes `bn`, `gn`, `ln`, `brn`, `in_scale` /
    `in_offset`): one dispatch for ConvBlock and the transposed, dilated and
    3-D blocks, which accept a subset of the names (TAIL_NORMS). The
    subclass sets `norm` and `dtype`."""

    def _normalise(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm == "batch":
            return self.bn(x)
        if self.norm == "batch_bf16":
            return self.bn(x).to(self.dtype)
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


class ConvBlock(_Normalised):
    """Conv2D + optional normalisation + activation + optional dropout
    (ref layers.py:94-145; JAX layers.py:116-216).

    SAME padding, as Flax pads it: with `stride` 2 an even side is padded
    on the high edge only; the conv has a bias unless norm="batch" (renorm keeps it,
    as JAX's `use_bias = norm != "batch"`); the norm comes before the
    activation. The norms (ref tfwrapper/normalisation.py):

      batch     BatchNorm, momentum .99, eps 1e-3, in f32            (`bn`)
      batch_bf16  the same BatchNorm (statistics and normalisation in f32,
                the same `bn` parameters and buffers), its output cast to
                the compute dtype before the activation, which then runs in
                that dtype; the conv keeps its bias, as in JAX (`bn`)
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
                 dropout_keep_prob: Optional[float] = None, stride: int = 1):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"unknown norm: {norm!r}")
        get_weight_init(weight_init)  # unknown names raise here
        self.conv = nn.Conv2d(in_features, features, kernel_size, stride=stride,
                              padding=kernel_size // 2 if stride == 1 else 0,
                              bias=norm != "batch")
        self.norm = norm
        self.weight_init = weight_init
        self.dropout_keep_prob = dropout_keep_prob
        if norm in ("batch", "batch_bf16"):
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
        x = x.to(self.dtype)
        if self.conv.stride != (1, 1):
            x = F.pad(x, _same_pads(x.shape[2:], self.conv.kernel_size, self.conv.stride))
        x = F.conv2d(x, w, b, stride=self.conv.stride, padding=self.conv.padding)
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


def _same_pads(sizes, kernel, stride, dilation=None) -> Tuple[int, ...]:
    """F.pad's pads (last dim first, low edge then high) of XLA's SAME
    padding of a convolution over `sizes`: the output side is
    ceil(in / stride) and the low edge gets the smaller half. A dilated
    kernel counts by its extent (k - 1) * dilation + 1."""
    pads = []
    for n, k, st, d in zip(sizes, kernel, stride, dilation or (1,) * len(sizes)):
        k = (k - 1) * d + 1
        total = max((-(-n // st) - 1) * st + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(p for pair in reversed(pads) for p in pair)


def _transposed_same_pads(kernel, stride) -> Tuple[int, ...]:
    """F.pad's pads (last dim first; negative crops) that turn the output of
    F.conv_transposeNd(padding=0) into that of lax.conv_transpose with SAME
    padding, as flax's ConvTranspose calls it. Both correlate the
    stride-dilated input with the kernel; torch pads the dilated input by
    k - 1 on each side, lax by (a, k + s - 2 - a) with a = k - 1 when
    s > k - 1, else ceil((k + s - 2) / 2) (jax/_src/lax/convolution.py
    _conv_transpose_padding). With k = 3, s = 2 that is (2, 1), which no
    `padding` / `output_padding` pair of torch's gives."""
    pads = []
    for k, st in zip(kernel, stride):
        total = k + st - 2
        lo = k - 1 if st > k - 1 else -(-total // 2)
        pads.append((lo - (k - 1), total - lo - (k - 1)))
    return tuple(p for pair in reversed(pads) for p in pair)


class ResidualUnit(nn.Module):
    """Residual unit with optional downsampling / projection (ref
    layers.py:428-536, He et al. 2015; JAX layers.py:263-288).

    c1 (stride 2 when down_sample) then c2 without its activation, plus the
    shortcut: x itself, or a 1x1 convolution `proj` (he_normal, with bias, in
    the compute dtype) when the unit downsamples or changes the width; the
    activation after the sum. The attribute names are the Flax scopes."""

    def __init__(self, in_features: int, features: int, down_sample: bool = False,
                 activation: Activation = F.relu, norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        stride = 2 if down_sample else 1
        self.proj = (nn.Conv2d(in_features, features, 1, stride=stride)
                     if down_sample or in_features != features else None)
        self.c1 = ConvBlock(in_features, features, activation=activation, norm=norm,
                            dtype=dtype, stride=stride)
        self.c2 = ConvBlock(features, features, activation=None, norm=norm, dtype=dtype)
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.proj is not None:
            shortcut = F.conv2d(x.to(self.dtype), self.proj.weight.to(self.dtype),
                                self.proj.bias.to(self.dtype), stride=self.proj.stride)
        out = self.c2(self.c1(x)) + shortcut
        return self.activation(out) if self.activation is not None else out


class Dense(nn.Module):
    """Dense layer on the last axis (ref layers.py:539-582; JAX
    layers.py:326-338): he_normal kernel, bias, the product in the compute
    dtype, then the activation. `Dense_0` is the Flax scope of the inner
    layer, whose (in, out) kernel converts to the Linear's (out, in)."""

    def __init__(self, in_features: int, features: int, activation: Activation = F.relu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lin = self.Dense_0
        x = F.linear(x.to(self.dtype), lin.weight.to(self.dtype), lin.bias.to(self.dtype))
        return self.activation(x) if self.activation is not None else x


TAIL_NORMS = ("batch", "group", "none")


class _ConvNormAct(_Normalised):
    """A convolution in the compute dtype, then the shared norm-and-activation
    tail of JAX's transposed, dilated and 3-D blocks (JAX layers.py:311-323,
    `_norm_act`): norm batch (`bn`, f32) or group (`gn`, max(2, C // 16)
    groups, eps 1e-5, f32) or none, the activation, the output in the
    compute dtype. The conv has a bias unless norm is batch. Subclasses set
    `self.<scope>` to their torch conv module and `_conv` to the forward of
    the convolution without its bias."""

    scope = ""

    def __init__(self, conv: nn.Module, features: int, activation: Activation, norm: str,
                 dtype: torch.dtype):
        super().__init__()
        if norm not in TAIL_NORMS:
            raise ValueError(f"unknown norm: {norm!r}")
        self.add_module(self.scope, conv)
        if norm == "batch":
            self.bn = BatchNorm(features)
        elif norm == "group":
            self.gn = nn.GroupNorm(max(2, features // 16), features, eps=1e-5)
        self.norm = norm
        self.activation = activation
        self.dtype = dtype

    @property
    def conv_module(self) -> nn.Module:
        return getattr(self, self.scope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv_module
        x = self._conv(x.to(self.dtype), conv.weight.to(self.dtype))
        if conv.bias is not None:
            x = x + conv.bias.to(self.dtype).view(-1, *([1] * (x.dim() - 2)))
        x = self._normalise(x)
        if self.activation is not None:
            x = self.activation(x)
        return x.to(self.dtype)


class TransposedConvBlock(_ConvNormAct):
    """Transposed (fractionally strided) conv + norm + activation, NCHW (ref
    layers.py:197-257; JAX layers.py:219-237): 4x4 kernel, stride 2 by
    default, SAME padding as lax.conv_transpose pads it (the output side is
    in * stride). `conv_t` is a ConvTranspose2d, whose (in, out, kh, kw)
    weight is Flax's (kh, kw, in, out) kernel flipped in space
    (phiseg_tpu_torch/convert.py)."""

    scope = "conv_t"

    def __init__(self, in_features: int, features: int, kernel_size=4, stride=2,
                 activation: Activation = F.relu, norm: str = "none",
                 dtype: torch.dtype = torch.float32):
        super().__init__(nn.ConvTranspose2d(in_features, features, kernel_size, stride=stride,
                                            bias=norm != "batch"),
                         features, activation, norm, dtype)

    def _conv(self, x, w):
        conv = self.conv_t
        return F.pad(F.conv_transpose2d(x, w, stride=conv.stride),
                     _transposed_same_pads(conv.kernel_size, conv.stride))


class DilatedConvBlock(_ConvNormAct):
    """Atrous conv + norm + activation, NCHW (ref layers.py:378-425; JAX
    layers.py:240-260): 3x3 kernel at dilation `rate`, stride 1, SAME
    padding over the dilated extent. Scope `conv_d`."""

    scope = "conv_d"

    def __init__(self, in_features: int, features: int, kernel_size=3, rate: int = 2,
                 activation: Activation = F.relu, norm: str = "none",
                 dtype: torch.dtype = torch.float32):
        super().__init__(nn.Conv2d(in_features, features, kernel_size, dilation=rate,
                                   bias=norm != "batch"),
                         features, activation, norm, dtype)

    def _conv(self, x, w):
        conv = self.conv_d
        x = F.pad(x, _same_pads(x.shape[2:], conv.kernel_size, (1, 1), conv.dilation))
        return F.conv2d(x, w, dilation=conv.dilation)


class Conv3DBlock(_ConvNormAct):
    """3-D conv + norm + activation, NCDHW (ref layers.py:148-194; JAX
    layers.py:291-308): 3x3x3 kernel, SAME padding as XLA pads it, also
    with stride 2. Scope `conv3d`."""

    scope = "conv3d"

    def __init__(self, in_features: int, features: int, kernel_size=3, stride=1,
                 activation: Activation = F.relu, norm: str = "none",
                 dtype: torch.dtype = torch.float32):
        super().__init__(nn.Conv3d(in_features, features, kernel_size, stride=stride,
                                   bias=norm != "batch"),
                         features, activation, norm, dtype)

    def _conv(self, x, w):
        conv = self.conv3d
        x = F.pad(x, _same_pads(x.shape[2:], conv.kernel_size, conv.stride))
        return F.conv3d(x, w, stride=conv.stride)


class TransposedConv3DBlock(_ConvNormAct):
    """3-D transposed conv + norm + activation, NCDHW (ref layers.py:260-323;
    JAX layers.py:341-361): 4x4x4 kernel, stride 2 by default, padded as
    TransposedConvBlock. Scope `conv_t3d`, a ConvTranspose3d."""

    scope = "conv_t3d"

    def __init__(self, in_features: int, features: int, kernel_size=4, stride=2,
                 activation: Activation = F.relu, norm: str = "none",
                 dtype: torch.dtype = torch.float32):
        super().__init__(nn.ConvTranspose3d(in_features, features, kernel_size, stride=stride,
                                            bias=norm != "batch"),
                         features, activation, norm, dtype)

    def _conv(self, x, w):
        conv = self.conv_t3d
        return F.pad(F.conv_transpose3d(x, w, stride=conv.stride),
                     _transposed_same_pads(conv.kernel_size, conv.stride))


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
    norms keep scale 1 and bias 0, running mean 0 and variance 1. A
    ResidualUnit's projection, a Dense layer and the convolution of a
    transposed, dilated or 3-D block get he_normal and a zero bias."""
    for m in module.modules():
        if isinstance(m, (ResidualUnit, Dense)):
            layer = m.Dense_0 if isinstance(m, Dense) else m.proj
            if layer is not None:  # a unit without a projection has none
                WEIGHT_INITS["he_normal"](layer.weight, generator)
                with torch.no_grad():
                    layer.bias.zero_()
        if isinstance(m, _ConvNormAct):
            w = m.conv_module.weight
            if isinstance(m, (TransposedConvBlock, TransposedConv3DBlock)):
                w = w.transpose(0, 1)  # (in, out, ...): Flax's fan_in counts `in`
            WEIGHT_INITS["he_normal"](w, generator)
            if m.conv_module.bias is not None:
                with torch.no_grad():
                    m.conv_module.bias.zero_()
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
