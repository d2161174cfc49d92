"""Shared building blocks of the model families (port of
phiseg_tpu/models/components.py:35-230).

All tensors inside are NCHW. Module attribute names are the Flax scope
names, so `posterior.tower.level0_conv0.conv.weight` here is
`params/posterior/tower/level0_conv0/conv/kernel` there.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from phiseg_tpu_torch.nn.layers import (
    ConvBlock,
    avg_pool_2x2,
    reparameterize,
    upsample_bilinear,
)


def default_channels(n0: int, resolution_levels: int) -> Tuple[int, ...]:
    """Per-level channel schedule [n0, 2n0, 4n0, 6n0, 6n0, ...] (ref posteriors.py:59)."""
    mults = [1, 2, 4] + [6] * max(0, resolution_levels - 3)
    return tuple(n0 * m for m in mults[:resolution_levels])


def latent_map_shapes(batch: int, image_size: Tuple[int, int], skipped: int, levels: int,
                      zdim: int) -> Tuple[Tuple[int, ...], ...]:
    """NHWC shapes of `levels` latent maps, finest first: the image halved
    (SAME pooling rounds up) `skipped` times, then once more a level."""
    h, w = image_size
    return tuple((batch, -(-h // 2 ** k), -(-w // 2 ** k), zdim)
                 for k in range(skipped, skipped + levels))


class EncoderTower(nn.Module):
    """R resolution levels of 3 conv blocks each, 2x2 avg-pool between levels
    (ref posteriors.py:84-95). Returns the per-level features, finest first."""

    def __init__(self, in_features: int, n0: int, resolution_levels: int,
                 norm: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resolution_levels = resolution_levels
        self.dtype = dtype
        ch = default_channels(n0, resolution_levels)
        cin = in_features
        for i in range(resolution_levels):
            for k in range(3):
                self.add_module(f"level{i}_conv{k}", ConvBlock(cin, ch[i], norm=norm, dtype=dtype))
                cin = ch[i]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        feats = []
        net = x.to(self.dtype)
        for i in range(self.resolution_levels):
            if i > 0:
                net = avg_pool_2x2(net)
            for k in range(3):
                net = getattr(self, f"level{i}_conv{k}")(net)
            feats.append(net)
        return tuple(feats)


class GaussianHead(nn.Module):
    """(mu, softplus-sigma) conv heads with biases and no norm
    (ref posteriors.py:105-107); `mu_kernel` is 3 at the coarsest latent
    level and 1 elsewhere, a reference quirk kept for parity."""

    def __init__(self, in_features: int, zdim: int, mu_kernel: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mu = ConvBlock(in_features, zdim, kernel_size=mu_kernel, activation=None,
                            norm="none", dtype=dtype)
        self.sigma = ConvBlock(in_features, zdim, kernel_size=1, activation=F.softplus,
                               norm="none", dtype=dtype)

    def forward(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.mu(feats), self.sigma(feats)


class LatentHierarchy(nn.Module):
    """Coarse-to-fine autoregressive latent chain over L levels
    (ref posteriors.py:98-130, priors.py:91-126).

    Level i < L-1 takes the level-(i+1) sample, upsamples it bilinearly,
    refines it with two convs, concatenates it with the encoder feature at
    the matching resolution and predicts (mu, sigma). With `z_chain_source`
    (teacher forcing, priors.py:122-126) the chain consumes those z's; then
    this module's own draws are unused, so none are made.
    """

    def __init__(self, zdim0: int, n0: int, latent_levels: int, resolution_levels: int,
                 norm: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__()
        L, R = latent_levels, resolution_levels
        D = R - L
        ch = default_channels(n0, R)
        self.latent_levels = L
        self.lvl_diff = D
        self.dtype = dtype
        for i in range(L):
            head_in = ch[i + D] if i == L - 1 else ch[i]
            self.add_module(f"z{i}_head", GaussianHead(
                head_in, zdim0, mu_kernel=3 if i == L - 1 else 1, dtype=dtype))
        for i in range(L - 1):
            # two refinement convs on the upsampled z (zdim0*n0 filters,
            # posteriors.py:115-116), two on the concat (ch[i], :122-123)
            self.add_module(f"z{i}_ups_conv0", ConvBlock(zdim0, zdim0 * n0, norm=norm, dtype=dtype))
            self.add_module(f"z{i}_ups_conv1", ConvBlock(zdim0 * n0, zdim0 * n0, norm=norm, dtype=dtype))
            self.add_module(f"z{i}_input_conv0",
                            ConvBlock(ch[i + D] + zdim0 * n0, ch[i], norm=norm, dtype=dtype))
            self.add_module(f"z{i}_input_conv1", ConvBlock(ch[i], ch[i], norm=norm, dtype=dtype))

    def forward(self, pre_z: Sequence[torch.Tensor],
                eps: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                z_chain_source: Optional[Sequence[torch.Tensor]] = None):
        """Returns (z, mu, sigma) tuples, finest level first. `eps` holds
        NCHW noise per level; z is None everywhere under teacher forcing."""
        L, D = self.latent_levels, self.lvl_diff
        eps = [None] * L if eps is None else list(eps)
        z: List[Optional[torch.Tensor]] = [None] * L
        mu: List[Optional[torch.Tensor]] = [None] * L
        sigma: List[Optional[torch.Tensor]] = [None] * L
        for i in reversed(range(L)):
            if i == L - 1:
                feats = pre_z[i + D]
            else:
                chain_z = z_chain_source[i + 1] if z_chain_source is not None else z[i + 1]
                zb = upsample_bilinear(chain_z.to(self.dtype), 2)
                zb = getattr(self, f"z{i}_ups_conv1")(getattr(self, f"z{i}_ups_conv0")(zb))
                feats = torch.cat([pre_z[i + D], zb], dim=1)
                feats = getattr(self, f"z{i}_input_conv0")(feats)
                feats = getattr(self, f"z{i}_input_conv1")(feats)
            mu[i], sigma[i] = getattr(self, f"z{i}_head")(feats)
            if z_chain_source is None:
                z[i] = reparameterize(mu[i], sigma[i], eps[i], generator)
        return tuple(z), tuple(mu), tuple(sigma)


class UNetCore(nn.Module):
    """U-Net encoder + decoder, returning the full-resolution feature map
    (ref likelihoods.py:28-71, :104-145; JAX components.py:191-230).

    Each decoder step upsamples bilinearly x2, concatenates the encoder
    feature of the next finer level and runs three conv blocks. Every
    decoder conv of step jj has ch[R - jj - 1] channels, the deeper level's
    count, a reference quirk kept for parity.
    """

    def __init__(self, in_features: int, n0: int, resolution_levels: int,
                 norm: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__()
        R = resolution_levels
        ch = default_channels(n0, R)
        self.resolution_levels = R
        self.encoder = EncoderTower(in_features, n0, R, norm, dtype)
        cin = ch[R - 1]
        for jj in range(R - 1):
            cin += ch[R - jj - 2]  # the skip's channels
            for k in range(3):
                self.add_module(f"dec{jj}_conv{k}",
                                ConvBlock(cin, ch[R - jj - 1], norm=norm, dtype=dtype))
                cin = ch[R - jj - 1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        R = self.resolution_levels
        enc = self.encoder(x)
        net = enc[-1]
        for jj in range(R - 1):
            net = torch.cat([upsample_bilinear(net, 2), enc[R - jj - 2]], dim=1)
            for k in range(3):
                net = getattr(self, f"dec{jj}_conv{k}")(net)
        return net
