"""The PHiSeg posterior, prior and likelihood (port of
phiseg_tpu/models/families.py:51-222). Tensors inside are NCHW.

The Probabilistic U-Net and deterministic U-Net families are not ported yet
(ROADMAP Queue 1: the other two families).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from phiseg_tpu_torch.models.components import (
    EncoderTower,
    LatentHierarchy,
    default_channels,
)
from phiseg_tpu_torch.nn.layers import (
    ConvBlock,
    at_least_f32,
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
        self.dtype = dtype
        self.tower = EncoderTower(image_channels, n0, resolution_levels, norm, dtype)
        self.hierarchy = LatentHierarchy(zdim0, n0, latent_levels, resolution_levels, norm, dtype)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The x-only part: the encoder features, finest first (ref families.py:107-108)."""
        return self.tower(x.to(self.dtype))

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

    def forward(self, z_list: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """Per-level f32 logits, NCHW at the image size, finest level first."""
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
