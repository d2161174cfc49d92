"""The posteriors, priors and likelihoods of the three model families (port
of phiseg_tpu/models/families.py:51-407). Tensors inside are NCHW; the
Probabilistic U-Net's latents are (B, zdim) vectors.

  PHiSeg             hierarchical posterior / prior over L latent levels and
                     a per-level residual likelihood;
  Probabilistic U-Net one global latent from a pooled encoder, broadcast over
                     a U-Net's last feature map;
  deterministic U-Net a plain U-Net likelihood without latents.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from phiseg_tpu_torch.models.components import (
    EncoderTower,
    LatentHierarchy,
    UNetCore,
    default_channels,
    latent_map_shapes,
)
from phiseg_tpu_torch.nn.layers import (
    ConvBlock,
    at_least_f32,
    global_avg_pool,
    reparameterize,
    resize_nearest,
    upsample_bilinear,
)


class PhiSegPosterior(nn.Module):
    """Hierarchical posterior q(z_{1..L} | x, s) (ref posteriors.py:56-132)."""

    def __init__(self, image_channels: int, nlabels: int, zdim0: int, n0: int,
                 latent_levels: int, resolution_levels: int, norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.tower = EncoderTower(image_channels + nlabels, n0, resolution_levels, norm, dtype)
        self.hierarchy = LatentHierarchy(zdim0, n0, latent_levels, resolution_levels, norm, dtype)

    def forward(self, x: torch.Tensor, s_oh: torch.Tensor,
                eps: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        # Conditioning on the segmentation: concat(x, s_onehot - 0.5) in the
        # compute dtype (ref posteriors.py:87, families.py:77).
        inp = torch.cat([x, s_oh - 0.5], dim=1).to(self.dtype)
        return self.hierarchy(self.tower(inp), eps=eps, generator=generator)


class PhiSegPrior(nn.Module):
    """Hierarchical prior p(z_{1..L} | x) (ref priors.py:51-128). In training
    its chain is teacher-forced with the posterior's samples (priors.py:126)."""

    def __init__(self, image_channels: int, zdim0: int, n0: int, latent_levels: int,
                 resolution_levels: int, norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.zdim0 = dtype, zdim0
        self.tower = EncoderTower(image_channels, n0, resolution_levels, norm, dtype)
        self.hierarchy = LatentHierarchy(zdim0, n0, latent_levels, resolution_levels, norm, dtype)

    def latent_shapes(self, batch: int, image_size: Tuple[int, int]):
        """z's NHWC shape at each level, finest first: the image halved
        R - L + i times at level i."""
        h = self.hierarchy
        return latent_map_shapes(batch, image_size, h.lvl_diff, h.latent_levels, self.zdim0)

    def encode(self, x: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
        """The x-only part: the encoder features, finest first (ref
        families.py:107-108), None at the R - L finest levels, which the
        heads do not read: so the sampler neither keeps nor tiles them."""
        feats = self.tower(x.to(self.dtype))
        skipped = self.hierarchy.lvl_diff
        return (None,) * skipped + tuple(feats[skipped:])

    def heads(self, pre_z: Sequence[torch.Tensor],
              z_teacher: Optional[Sequence[torch.Tensor]] = None,
              eps: Optional[Sequence[torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None):
        """(z, mu, sigma) from the encoder features (ref families.py:110-118)."""
        return self.hierarchy(pre_z, eps=eps, generator=generator, z_chain_source=z_teacher)

    def forward(self, x: torch.Tensor, z_teacher: Optional[Sequence[torch.Tensor]] = None,
                eps: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        return self.heads(self.encode(x), z_teacher=z_teacher, eps=eps, generator=generator)


class PhiSegLikelihood(nn.Module):
    """Per-level residual decoder p(s | z_{1..L}) (ref likelihoods.py:162-223).

    Each latent level is decoded through R-L upsample-conv steps, merged
    top-down, projected to per-level class logits and nearest-resized to the
    image size; the logits are cast to f32 after the resize (families.py:211).
    """

    def __init__(self, zdim0: int, n0: int, latent_levels: int, resolution_levels: int,
                 nlabels: int, image_size: Tuple[int, int], norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        L, R = latent_levels, resolution_levels
        D = R - L
        ch = default_channels(n0, R)
        self.latent_levels, self.lvl_diff = L, D
        self.image_size = tuple(image_size)
        self.dtype = dtype
        for i in range(L):
            self.add_module(f"z{i}_post0", ConvBlock(zdim0, ch[i], norm=norm, dtype=dtype))
            self.add_module(f"z{i}_post1", ConvBlock(ch[i], ch[i], norm=norm, dtype=dtype))
            for k in range(D):
                self.add_module(f"z{i}_preups{k}", ConvBlock(ch[i], ch[i], norm=norm, dtype=dtype))
        # Top-down merge path (likelihoods.py:204-215). The merge convs have
        # ch[i + D] channels, a reference quirk kept for parity (:212-213).
        post_c_ch = [ch[i + D] for i in range(L - 1)] + [ch[L - 1]]
        for i in range(L - 1):
            self.add_module(f"post_c{i}_ups", ConvBlock(post_c_ch[i + 1], ch[i], norm=norm, dtype=dtype))
            self.add_module(f"post_c{i}_merge0", ConvBlock(2 * ch[i], ch[i + D], norm=norm, dtype=dtype))
            self.add_module(f"post_c{i}_merge1", ConvBlock(ch[i + D], ch[i + D], norm=norm, dtype=dtype))
        for i in range(L):
            self.add_module(f"out{i}", ConvBlock(post_c_ch[i], nlabels, kernel_size=1,
                                                 activation=None, norm="none", dtype=dtype))

    def forward(self, z_list: Sequence[torch.Tensor],
                x: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
        """Per-level f32 logits, NCHW at the image size, finest level first.
        x is not read: the PHiSeg likelihood decodes the latents alone."""
        del x
        L, D = self.latent_levels, self.lvl_diff
        post_z = []
        for i in range(L):
            net = z_list[i].to(self.dtype)
            net = getattr(self, f"z{i}_post1")(getattr(self, f"z{i}_post0")(net))
            for k in range(D):
                net = getattr(self, f"z{i}_preups{k}")(upsample_bilinear(net, 2))
            post_z.append(net)

        post_c = [None] * L
        post_c[L - 1] = post_z[L - 1]
        for i in reversed(range(L - 1)):
            ups = getattr(self, f"post_c{i}_ups")(upsample_bilinear(post_c[i + 1], 2))
            net = torch.cat([post_z[i], ups], dim=1)
            net = getattr(self, f"post_c{i}_merge0")(net)
            post_c[i] = getattr(self, f"post_c{i}_merge1")(net)

        return tuple(
            at_least_f32(resize_nearest(getattr(self, f"out{i}")(post_c[i]), self.image_size))
            for i in range(L)
        )

    # The PHiSeg likelihood has no x-dependent part: its sampling cache is
    # empty and from_features simply decodes (ref families.py:214-222).
    def features(self, x: torch.Tensor) -> tuple:
        del x
        return ()

    def from_features(self, cache, z_list: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        del cache
        return self(z_list)


# ---------------------------------------------------------------------------
# Probabilistic U-Net (ref posteriors.py:9-52, priors.py:8-48,
# likelihoods.py:81-159; JAX families.py:231-369)
# ---------------------------------------------------------------------------


class GlobalGaussianEncoder(nn.Module):
    """Encoder tower, 1x1 (mu, sigma) heads with biases and no norm, then a
    global average pool; softplus comes BEFORE the pool, as in the reference
    (JAX families.py:255-259). Returns (mu, sigma), each (B, zdim)."""

    def __init__(self, in_features: int, zdim0: int, n0: int, resolution_levels: int,
                 norm: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = default_channels(n0, resolution_levels)
        self.tower = EncoderTower(in_features, n0, resolution_levels, norm, dtype)
        self.pre_mu = ConvBlock(ch[-1], zdim0, kernel_size=1, activation=None, norm="none",
                                dtype=dtype)
        self.pre_sigma = ConvBlock(ch[-1], zdim0, kernel_size=1, activation=F.softplus,
                                   norm="none", dtype=dtype)

    def forward(self, inp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = self.tower(inp)[-1]
        return global_avg_pool(self.pre_mu(feats)), global_avg_pool(self.pre_sigma(feats))


def _draw_one(mu: torch.Tensor, sigma: torch.Tensor, eps: Optional[Sequence[torch.Tensor]],
              generator: Optional[torch.Generator]):
    """The one-level (z, mu, sigma) tuples of a global latent."""
    z = reparameterize(mu, sigma, None if eps is None else eps[0], generator)
    return (z,), (mu,), (sigma,)


class ProbUNetPosterior(nn.Module):
    """One global latent q(z | x, s) (ref posteriors.py:9-52)."""

    def __init__(self, image_channels: int, nlabels: int, zdim0: int, n0: int,
                 resolution_levels: int, norm: str = "batch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = GlobalGaussianEncoder(image_channels + nlabels, zdim0, n0,
                                             resolution_levels, norm, dtype)

    def forward(self, x: torch.Tensor, s_oh: torch.Tensor,
                eps: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        inp = torch.cat([x, s_oh - 0.5], dim=1).to(self.dtype)
        return _draw_one(*self.encoder(inp), eps, generator)


class ProbUNetPrior(nn.Module):
    """One global latent p(z | x) (ref priors.py:8-48). There is no chain, so
    teacher forcing has nothing to feed: with `z_teacher` given (the training
    forward) only (mu, sigma) are wanted, and no z is drawn."""

    def __init__(self, image_channels: int, zdim0: int, n0: int, resolution_levels: int,
                 norm: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.zdim0 = dtype, zdim0
        self.encoder = GlobalGaussianEncoder(image_channels, zdim0, n0, resolution_levels,
                                             norm, dtype)

    def latent_shapes(self, batch: int, image_size: Tuple[int, int]):
        """z's one shape: (batch, zdim0), whatever the image."""
        del image_size
        return ((batch, self.zdim0),)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, sigma) of x, each (B, zdim)."""
        return self.encoder(x.to(self.dtype))

    def heads(self, cache, z_teacher=None, eps: Optional[Sequence[torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None):
        mu, sigma = cache
        if z_teacher is not None:
            return (None,), (mu,), (sigma,)
        return _draw_one(mu, sigma, eps, generator)

    def forward(self, x: torch.Tensor, z_teacher=None,
                eps: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        return self.heads(self.encode(x), z_teacher=z_teacher, eps=eps, generator=generator)


class UNetRecomb(nn.Module):
    """UNetCore and three 1x1 conv blocks of n0 channels with batch norm
    (`recomb0..2`): the backbone of both U-Net likelihoods (ref
    likelihoods.py:10-79, :81-159) and of SSN's heads (models/ssn.py).
    `extra` channels join the U-Net's features before the first 1x1 block."""

    def __init__(self, image_channels: int, n0: int, resolution_levels: int, extra: int,
                 norm: str, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.unet = UNetCore(image_channels, n0, resolution_levels, norm, dtype)
        cin = default_channels(n0, resolution_levels)[1] + extra  # the last decoder step's
        for k in range(3):
            self.add_module(f"recomb{k}", ConvBlock(cin, n0, kernel_size=1, norm=norm, dtype=dtype))
            cin = n0

    def recomb(self, net: torch.Tensor) -> torch.Tensor:
        """The three 1x1 blocks on `net`. Pass it as a temporary: each
        block's input is freed once the next block has its output."""
        for k in range(3):
            net = getattr(self, f"recomb{k}")(net)
        return net


class _UNetHead(UNetRecomb):
    """UNetRecomb and the 1x1 `prediction` conv, whose logits are cast to
    f32 (`_predict` of the recomb blocks' output): the shared layout of both
    U-Net likelihoods."""

    def __init__(self, image_channels: int, n0: int, resolution_levels: int, nlabels: int,
                 extra: int, norm: str, dtype: torch.dtype):
        super().__init__(image_channels, n0, resolution_levels, extra, norm, dtype)
        self.prediction = ConvBlock(n0, nlabels, kernel_size=1, activation=None, norm="none",
                                    dtype=dtype)

    def _predict(self, net: torch.Tensor) -> torch.Tensor:
        return at_least_f32(self.prediction(net))


class ProbUNetLikelihood(_UNetHead):
    """U-Net likelihood with the latent tiled over the grid and concatenated
    after the last decoder feature map (ref likelihoods.py:147-157). The U-Net
    features depend on x alone: the sampler computes them once per image."""

    def __init__(self, image_channels: int, zdim0: int, n0: int, resolution_levels: int,
                 nlabels: int, norm: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__(image_channels, n0, resolution_levels, nlabels, zdim0, norm, dtype)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self.unet(x.to(self.dtype))

    def from_features(self, feats: torch.Tensor,
                      z_list: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        z = z_list[0].to(self.dtype)  # (B, zdim)
        b, _, h, w = feats.shape
        z_b = z[:, :, None, None].expand(b, z.shape[1], h, w)
        return (self._predict(self.recomb(torch.cat([feats, z_b], dim=1))),)

    def forward(self, z_list: Sequence[torch.Tensor], x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.from_features(self.features(x), z_list)


class DetUNetLikelihood(_UNetHead):
    """Plain U-Net p(s | x); no latents (ref likelihoods.py:10-79). Its
    features are its f32 logits."""

    def __init__(self, image_channels: int, n0: int, resolution_levels: int, nlabels: int,
                 norm: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__(image_channels, n0, resolution_levels, nlabels, 0, norm, dtype)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self._predict(self.recomb(self.unet(x.to(self.dtype))))

    def from_features(self, logits: torch.Tensor, z_list=None) -> Tuple[torch.Tensor, ...]:
        del z_list
        return (logits,)

    def forward(self, z_list, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        del z_list
        return self.from_features(self.features(x))
