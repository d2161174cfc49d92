"""SegVAE: the combined segmentation VAE of the model families (port of
phiseg_tpu/models/segvae.py:43-174, plus the Hierarchical Probabilistic
U-Net, models/hpunet.py, which the JAX package does not have).

The training forward takes and returns the JAX layout (NHWC, class axis
last) and runs NCHW inside. Train or eval batch-norm mode is the module's
own `training` flag: the JAX package's sampling methods always run in eval
mode, so call `.eval()` before them (engine/train.py's samplers do).

Methods (ref segvae.py:117-174):

  forward        the training forward (posterior sample, teacher-forced
                 prior, likelihood on the posterior z's);
  sample_cache   all x-dependent computation for prior sampling, run once;
  decode_sample  one prior draw per batch row -> per-level logits; the
                 sampler tiles the cache to S x B rows and decodes all draws
                 in one call, where the JAX package vmaps over keys;
  sample_logits, prior_draw, posterior_draw, decode_z.

Every method that draws takes `eps` (per level, shaped like z) to inject the
noise, else draws it from `generator`. PHiSeg's z at each level is an NHWC
map; the Probabilistic U-Net's one z is a (B, zdim) vector, which passes the
NCHW/NHWC boundary unchanged. The deterministic U-Net has no latents: its
z, posterior and prior tuples are empty and every draw decodes the same
logits. The HPU-Net's z are NHWC maps at its L coarsest scales; its one
level of logits comes from a decoder that runs to full resolution for every
draw, so its sampler tiles all of the prior's encoder features.
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
from phiseg_tpu_torch.models.hpunet import GecoState, HPUNetCore, StitchingDecoder
from phiseg_tpu_torch.nn.layers import nchw, nhwc
from phiseg_tpu_torch.utils.profiling import span

FAMILIES = ("phiseg", "prob_unet", "det_unet", "hpu_net")
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


def _latent_nchw(t: torch.Tensor) -> torch.Tensor:
    """A latent map NHWC -> NCHW; a (B, zdim) latent as it is."""
    return nchw(t) if t.ndim == 4 else t


def _latent_nhwc(t: torch.Tensor) -> torch.Tensor:
    """A latent map NCHW -> NHWC; a (B, zdim) latent as it is."""
    return nhwc(t) if t.ndim == 4 else t


def _latents_nchw(eps: Optional[Sequence[torch.Tensor]]):
    return None if eps is None else [_latent_nchw(e) for e in eps]


def _draw_nhwc(out) -> Tuple[ZTuple, ZTuple, ZTuple]:
    return tuple(tuple(_latent_nhwc(t) for t in part) for part in out)


class SegVAE(nn.Module):
    def __init__(self, model_family: str = "phiseg", zdim0: int = 2, n0: int = 32,
                 latent_levels: int = 5, resolution_levels: int = 7, nlabels: int = 2,
                 image_size: Tuple[int, int] = (128, 128), norm: str = "batch",
                 dtype: torch.dtype = torch.float32, image_channels: int = 1):
        super().__init__()
        if model_family not in FAMILIES:
            raise ValueError(f"unknown model family: {model_family!r}")
        min_side = min(image_size)
        if min_side < 2 ** (resolution_levels - 1):
            raise ValueError(
                f"image_size {tuple(image_size)} too small for "
                f"resolution_levels={resolution_levels}: needs at least "
                f"{2 ** (resolution_levels - 1)} px per side so every "
                "encoder level halves the resolution."
            )
        self.model_family = model_family
        self.zdim0 = zdim0
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
        elif model_family == "hpu_net":  # no normalisation anywhere (models/hpunet.py)
            if norm != "none":
                raise ValueError(f"the HPU-Net has no normalisation: norm must be 'none', not {norm!r}")
            if any(side % 2 ** (resolution_levels - 1) for side in image_size):
                raise ValueError(f"the HPU-Net's nearest x2 upsampling needs image sides that "
                                 f"2^(R-1) = {2 ** (resolution_levels - 1)} divides, not "
                                 f"{tuple(image_size)}")
            lat = dict(zdim0=zdim0, n0=n0, latent_levels=latent_levels,
                       resolution_levels=resolution_levels, dtype=dtype)
            self.posterior = HPUNetCore(image_channels + nlabels, **lat)
            self.prior = HPUNetCore(image_channels, **lat)
            self.likelihood = StitchingDecoder(nlabels, n0, latent_levels, resolution_levels, dtype)
            self.geco = GecoState()
        else:  # det_unet: no posterior or prior (ref posteriors.py:135)
            self.likelihood = DetUNetLikelihood(image_channels, nlabels=nlabels, **common)

    @property
    def has_latents(self) -> bool:
        return self.model_family != "det_unet"

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
        if self.model_family == "hpu_net":
            return self._hpunet_forward(x_c, nchw(s_oh), eps, generator)
        if not self.has_latents:
            s_out = self.likelihood(None, x_c)
            return ModelOutputs(s_out_list=tuple(nhwc(t) for t in s_out),
                                z=(), q_mu=(), q_sigma=(), p_mu=(), p_sigma=())
        z, q_mu, q_sigma = self.posterior(x_c, nchw(s_oh), eps=_latents_nchw(eps),
                                          generator=generator)
        # Teacher-forced prior: its chain consumes the POSTERIOR's samples
        # (ref priors.py:126, phiseg_model.py:48-59).
        _, p_mu, p_sigma = self.prior(x_c, z_teacher=z)
        s_out = self.likelihood(z, x_c)
        z, q_mu, q_sigma, p_mu, p_sigma = _draw_nhwc((z, q_mu, q_sigma, p_mu, p_sigma))
        return ModelOutputs(s_out_list=tuple(nhwc(t) for t in s_out), z=z, q_mu=q_mu,
                            q_sigma=q_sigma, p_mu=p_mu, p_sigma=p_sigma)

    def _hpunet_forward(self, x_c, s_c, eps, generator) -> ModelOutputs:
        """The posterior core on concat(x, one-hot s) draws z; the prior core
        on x is teacher-forced with it and the stitching decoder reads the
        prior's encoder features (model.py `reconstruct`, `kl`)."""
        z, q_mu, q_sigma = self.posterior(torch.cat([x_c, s_c], dim=1), _latents_nchw(eps),
                                          generator)
        enc = self.prior.encode(x_c)
        f, _, p_mu, p_sigma = self.prior.decode(enc, z_inject=z)
        logits = self.likelihood(enc, f)
        z, q_mu, q_sigma, p_mu, p_sigma = _draw_nhwc((z, q_mu, q_sigma, p_mu, p_sigma))
        return ModelOutputs(s_out_list=(nhwc(logits),), z=z, q_mu=q_mu, q_sigma=q_sigma,
                            p_mu=p_mu, p_sigma=p_sigma)

    # -- inference sampling (encode once, draw many) ------------------------

    def latent_shapes(self, batch: int) -> Tuple[Tuple[int, ...], ...]:
        """The shape of z at each latent level, finest first. PHiSeg and the
        HPU-Net: NHWC, the image halved (SAME pooling rounds up) i + R - L
        times; the Probabilistic U-Net: (batch, zdim0); the deterministic
        U-Net: none."""
        if self.model_family == "prob_unet":
            return ((batch, self.zdim0),)
        if not self.has_latents:
            return ()
        hpu = self.model_family == "hpu_net"
        skipped, levels = ((self.prior.R - self.prior.L, self.prior.L) if hpu else
                           (self.likelihood.lvl_diff, self.likelihood.latent_levels))
        shapes = []
        h, w = self.image_size
        for _ in range(skipped):
            h, w = -(-h // 2), -(-w // 2)
        for _ in range(levels):
            shapes.append((batch, h, w, self.zdim0))
            h, w = -(-h // 2), -(-w // 2)
        return tuple(shapes)

    def sample_cache(self, x: torch.Tensor):
        """All x-dependent computation of prior sampling, of x (B,H,W,Cin):
        (prior encoder output, likelihood features), the deterministic
        U-Net's logits, or the HPU-Net prior's encoder features at every
        level."""
        x_c = nchw(x)
        if not self.has_latents:
            return self.likelihood.features(x_c)
        if self.model_family == "hpu_net":
            return self.prior.encode(x_c)
        return self.prior.encode(x_c), self.likelihood.features(x_c)

    def repeat_cache(self, cache, n: int):
        """The cache for n draws per image: row s*B + b holds image b. The
        PHiSeg prior's heads read only the features at levels >= R-L, so
        only those are tiled; the Probabilistic U-Net tiles its prior's
        (mu, sigma) and the likelihood's U-Net features. (The deterministic
        U-Net's draws are all one decode: the sampler does not tile.) The
        HPU-Net tiles every level of its prior's encoder features: each draw
        runs the decoder to full resolution."""
        if self.model_family == "hpu_net":
            return tuple(t.repeat(n, 1, 1, 1) for t in cache)
        prior_cache, lik_cache = cache
        if self.model_family == "prob_unet":
            return tuple(t.repeat(n, 1) for t in prior_cache), lik_cache.repeat(n, 1, 1, 1)
        tiled = tuple(None if i < self.likelihood.lvl_diff else t.repeat(n, 1, 1, 1)
                      for i, t in enumerate(prior_cache))
        return tiled, lik_cache

    def decode_sample(self, cache, eps: Optional[Sequence[torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None) -> ZTuple:
        """One prior draw per cache row -> per-level f32 logits, NHWC. The
        HPU-Net's decode is two spans: `sample.decode.latents` (the prior
        core's latent levels) and `sample.decode.stitch` (the stitching
        decoder and its logits)."""
        if not self.has_latents:
            return tuple(nhwc(t) for t in self.likelihood.from_features(cache))
        if self.model_family == "hpu_net":  # spans with CUDA events on the cache's device
            with span("sample.decode.latents", device=cache[0].device):
                f, _, _, _ = self.prior.decode(cache, _latents_nchw(eps), generator)
            with span("sample.decode.stitch", device=cache[0].device):
                return (nhwc(self.likelihood(cache, f)),)
        prior_cache, lik_cache = cache
        z, _, _ = self.prior.heads(prior_cache, eps=_latents_nchw(eps), generator=generator)
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
        return _draw_nhwc(self.prior(nchw(x), eps=_latents_nchw(eps), generator=generator))

    def posterior_draw(self, x: torch.Tensor, s_oh: torch.Tensor,
                       eps: Optional[Sequence[torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None):
        """Posterior (z, mu, sigma) (ref generate_posterior_samples :484-495)."""
        if not self.has_latents:
            return (), (), ()
        if self.model_family == "hpu_net":  # the core reads concat(x, s)
            return _draw_nhwc(self.posterior(torch.cat([nchw(x), nchw(s_oh)], dim=1),
                                             _latents_nchw(eps), generator))
        return _draw_nhwc(self.posterior(nchw(x), nchw(s_oh), eps=_latents_nchw(eps),
                                         generator=generator))

    def decode_z(self, z: Sequence[torch.Tensor], x: torch.Tensor) -> ZTuple:
        """Decode given latents with x (B,H,W,Cin), which the U-Net
        likelihoods read, NHWC (ref generate_samples_from_z :313-322)."""
        if self.model_family == "hpu_net":
            enc = self.prior.encode(nchw(x))
            f, _, _, _ = self.prior.decode(enc, z_inject=[_latent_nchw(t) for t in z])
            return (nhwc(self.likelihood(enc, f)),)
        return tuple(nhwc(t) for t in self.likelihood([_latent_nchw(t) for t in z], nchw(x)))
