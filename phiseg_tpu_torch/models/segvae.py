"""SegVAE: the combined segmentation VAE of the JAX package's three model
families (port of phiseg_tpu/models/segvae.py:43-174). The Hierarchical
Probabilistic U-Net, which the JAX package does not have, is its subclass
`HPUNet` (models/hpunet.py).

The training forward takes and returns the JAX layout (NHWC, class axis
last) and runs NCHW inside. Train or eval batch-norm mode is the module's
own `training` flag: the JAX package's sampling methods always run in eval
mode, so call `.eval()` before them (engine/train.py's samplers do).

Methods (ref segvae.py:117-174):

  forward        the training forward (posterior sample, teacher-forced
                 prior, likelihood on the posterior z's);
  sample_cache   all x-dependent computation for prior sampling, run once;
  decode_sample  one prior draw per batch row -> per-level logits; the
                 sampler tiles the cache to S x B rows (`repeat_cache`) and
                 decodes all draws in one call, where the JAX package vmaps
                 over keys;
  sample_logits, prior_draw, posterior_draw, decode_z.

Every method that draws takes `eps` (per level, shaped like z) to inject the
noise, else draws it from `generator`. PHiSeg's z at each level is an NHWC
map; the Probabilistic U-Net's one z is a (B, zdim) vector, which passes the
NCHW/NHWC boundary unchanged. The deterministic U-Net has no latents: its
z, posterior and prior tuples are empty and every draw decodes the same
logits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from phiseg_tpu_torch.models.families import (
    DetUNetLikelihood,
    PhiSegLikelihood,
    PhiSegPosterior,
    PhiSegPrior,
    ProbUNetLikelihood,
    ProbUNetPosterior,
    ProbUNetPrior,
)
from phiseg_tpu_torch.nn import layers
from phiseg_tpu_torch.nn.layers import nchw, nhwc

FAMILIES = ("phiseg", "prob_unet", "det_unet")
ZTuple = Tuple[torch.Tensor, ...]


@dataclasses.dataclass(frozen=True)
class ModelOutputs:
    """Training-forward outputs, each a per-level tuple in the JAX layout."""

    s_out_list: ZTuple  # per-level f32 logits from the likelihood on posterior z
    z: ZTuple           # posterior samples
    q_mu: ZTuple
    q_sigma: ZTuple
    p_mu: ZTuple        # teacher-forced prior params (for the KL)
    p_sigma: ZTuple


def aggregate_levels(s_list: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sum per-level logits into the final output (ref phiseg_model.py:304-311)."""
    total = s_list[-1]
    for s in s_list[:-1]:
        total = total + s
    return total


def check_image_size(image_size: Tuple[int, int], resolution_levels: int) -> None:
    """Refuse an image that the encoder cannot halve R-1 times."""
    if min(image_size) < 2 ** (resolution_levels - 1):
        raise ValueError(
            f"image_size {tuple(image_size)} too small for "
            f"resolution_levels={resolution_levels}: needs at least "
            f"{2 ** (resolution_levels - 1)} px per side so every "
            "encoder level halves the resolution."
        )


def latent_nchw(t: torch.Tensor) -> torch.Tensor:
    """A latent map NHWC -> NCHW; a (B, zdim) latent as it is."""
    return nchw(t) if t.ndim == 4 else t


def _latent_nhwc(t: torch.Tensor) -> torch.Tensor:
    """A latent map NCHW -> NHWC; a (B, zdim) latent as it is."""
    return nhwc(t) if t.ndim == 4 else t


def latents_nchw(eps: Optional[Sequence[torch.Tensor]]):
    return None if eps is None else [latent_nchw(e) for e in eps]


def draw_nhwc(out) -> Tuple[ZTuple, ...]:
    """Each tuple of latents (z, mu, sigma, ...) NCHW -> NHWC."""
    return tuple(tuple(_latent_nhwc(t) for t in part) for part in out)


def _tile(cache, n: int):
    """Every tensor in a nest of tuples tiled to n times its rows; None and
    empty tuples as they are."""
    if cache is None:
        return None
    if isinstance(cache, torch.Tensor):
        return cache.repeat(n, *(1,) * (cache.ndim - 1))
    return tuple(_tile(c, n) for c in cache)


class SegVAE(nn.Module):
    def __init__(self, model_family: str = "phiseg", zdim0: int = 2, n0: int = 32,
                 latent_levels: int = 5, resolution_levels: int = 7, nlabels: int = 2,
                 image_size: Tuple[int, int] = (128, 128), norm: str = "batch",
                 dtype: torch.dtype = torch.float32, image_channels: int = 1):
        super().__init__()
        if model_family not in FAMILIES:
            raise ValueError(f"unknown model family: {model_family!r}")
        check_image_size(image_size, resolution_levels)
        self.model_family = model_family
        self.image_size = tuple(image_size)
        self.dtype = dtype
        common = dict(n0=n0, resolution_levels=resolution_levels, norm=norm, dtype=dtype)
        if model_family == "phiseg":
            lat = dict(zdim0=zdim0, latent_levels=latent_levels, **common)
            self.posterior = PhiSegPosterior(image_channels, nlabels, **lat)
            self.prior = PhiSegPrior(image_channels, **lat)
            self.likelihood = PhiSegLikelihood(nlabels=nlabels, image_size=image_size, **lat)
        elif model_family == "prob_unet":  # one global latent, no chain
            self.posterior = ProbUNetPosterior(image_channels, nlabels, zdim0, **common)
            self.prior = ProbUNetPrior(image_channels, zdim0, **common)
            self.likelihood = ProbUNetLikelihood(image_channels, zdim0, nlabels=nlabels, **common)
        else:  # det_unet: no posterior or prior (ref posteriors.py:135)
            self.likelihood = DetUNetLikelihood(image_channels, nlabels=nlabels, **common)

    @property
    def has_latents(self) -> bool:
        return self.model_family != "det_unet"

    def init_weights_(self, generator: torch.Generator) -> None:
        """Flax's init of every block, from `generator` (nn/layers.py)."""
        layers.init_weights_(self, generator)

    def forward(self, x: torch.Tensor, s_oh: torch.Tensor,
                eps: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> ModelOutputs:
        """Training forward: posterior sample, teacher-forced prior, likelihood
        on the posterior z's (ref segvae.py:117-134).

        x: (B,H,W,Cin); s_oh: (B,H,W,nlabels). `eps` optionally injects the
        posterior's noise per level, shaped like z; else it is drawn from
        `generator`.
        """
        x_c = nchw(x)
        if not self.has_latents:
            s_out = self.likelihood(None, x_c)
            return ModelOutputs(s_out_list=tuple(nhwc(t) for t in s_out),
                                z=(), q_mu=(), q_sigma=(), p_mu=(), p_sigma=())
        z, q_mu, q_sigma = self.posterior(x_c, nchw(s_oh), eps=latents_nchw(eps),
                                          generator=generator)
        # Teacher-forced prior: its chain consumes the POSTERIOR's samples
        # (ref priors.py:126, phiseg_model.py:48-59).
        _, p_mu, p_sigma = self.prior(x_c, z_teacher=z)
        s_out = self.likelihood(z, x_c)
        z, q_mu, q_sigma, p_mu, p_sigma = draw_nhwc((z, q_mu, q_sigma, p_mu, p_sigma))
        return ModelOutputs(s_out_list=tuple(nhwc(t) for t in s_out), z=z, q_mu=q_mu,
                            q_sigma=q_sigma, p_mu=p_mu, p_sigma=p_sigma)

    # -- inference sampling (encode once, draw many) ------------------------

    def latent_shapes(self, batch: int) -> Tuple[Tuple[int, ...], ...]:
        """The shape of z at each latent level, finest first, as the prior
        draws it; none without latents."""
        if not self.has_latents:
            return ()
        return self.prior.latent_shapes(batch, self.image_size)

    def sample_cache(self, x: torch.Tensor):
        """All x-dependent computation of prior sampling, of x (B,H,W,Cin):
        (prior encoder output, likelihood features), or the deterministic
        U-Net's logits."""
        x_c = nchw(x)
        if not self.has_latents:
            return self.likelihood.features(x_c)
        return self.prior.encode(x_c), self.likelihood.features(x_c)

    def repeat_cache(self, cache, n: int):
        """The cache for n draws per image: every tensor in it tiled to n
        times its rows, so row s*B + b holds image b; None and empty entries
        stay as they are. (The deterministic U-Net's draws are all one
        decode: the sampler does not tile.)"""
        return _tile(cache, n)

    def decode_sample(self, cache, eps: Optional[Sequence[torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None) -> ZTuple:
        """One prior draw per cache row -> per-level f32 logits, NHWC."""
        if not self.has_latents:
            return tuple(nhwc(t) for t in self.likelihood.from_features(cache))
        prior_cache, lik_cache = cache
        z, _, _ = self.prior.heads(prior_cache, eps=latents_nchw(eps), generator=generator)
        return tuple(nhwc(t) for t in self.likelihood.from_features(lik_cache, z))

    def sample_logits(self, x: torch.Tensor, eps: Optional[Sequence[torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Single-sample aggregated logits (ref s_out_eval, phiseg_model.py:107)."""
        return aggregate_levels(self.decode_sample(self.sample_cache(x), eps, generator))

    # -- auxiliary APIs mirrored from the reference engine -------------------

    def prior_draw(self, x: torch.Tensor, eps: Optional[Sequence[torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None):
        """Prior (z, mu, sigma) (ref generate_prior_samples :325-334)."""
        if not self.has_latents:
            return (), (), ()
        return draw_nhwc(self.prior(nchw(x), eps=latents_nchw(eps), generator=generator))

    def posterior_draw(self, x: torch.Tensor, s_oh: torch.Tensor,
                       eps: Optional[Sequence[torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None):
        """Posterior (z, mu, sigma) (ref generate_posterior_samples :484-495)."""
        if not self.has_latents:
            return (), (), ()
        return draw_nhwc(self.posterior(nchw(x), nchw(s_oh), eps=latents_nchw(eps),
                                        generator=generator))

    def decode_z(self, z: Sequence[torch.Tensor], x: torch.Tensor) -> ZTuple:
        """Decode given latents with x (B,H,W,Cin), which the U-Net
        likelihoods read, NHWC (ref generate_samples_from_z :313-322)."""
        return tuple(nhwc(t) for t in self.likelihood([latent_nchw(t) for t in z], nchw(x)))
