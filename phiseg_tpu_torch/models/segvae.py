"""SegVAE: the combined segmentation VAE (port of phiseg_tpu/models/segvae.py:43-134).

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

Every method that draws takes `eps` (per level, NHWC like z) to inject the
noise, else draws it from `generator`. Only the PHiSeg family is ported; `prob_unet` and
`det_unet` raise (ROADMAP Queue 1: the other two families).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from phiseg_tpu_torch.models.families import PhiSegLikelihood, PhiSegPosterior, PhiSegPrior
from phiseg_tpu_torch.nn.layers import nchw, nhwc

FAMILIES = ("phiseg", "prob_unet", "det_unet")
ZTuple = Tuple[torch.Tensor, ...]


@dataclasses.dataclass(frozen=True)
class ModelOutputs:
    """Training-forward outputs, each a per-level tuple of NHWC tensors."""

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


class SegVAE(nn.Module):
    def __init__(self, model_family: str = "phiseg", zdim0: int = 2, n0: int = 32,
                 latent_levels: int = 5, resolution_levels: int = 7, nlabels: int = 2,
                 image_size: Tuple[int, int] = (128, 128), norm: str = "batch",
                 dtype: torch.dtype = torch.float32, image_channels: int = 1):
        super().__init__()
        if model_family not in FAMILIES:
            raise ValueError(f"unknown model family: {model_family!r}")
        if model_family != "phiseg":
            raise NotImplementedError(
                f"model family {model_family!r} is not ported yet "
                "(ROADMAP Queue 1: the ProbUNet and DetUNet families)"
            )
        min_side = min(image_size)
        if min_side < 2 ** (resolution_levels - 1):
            raise ValueError(
                f"image_size {tuple(image_size)} too small for "
                f"resolution_levels={resolution_levels}: needs at least "
                f"{2 ** (resolution_levels - 1)} px per side so every "
                "encoder level halves the resolution."
            )
        self.model_family = model_family
        self.zdim0, self.latent_levels = zdim0, latent_levels
        self.lvl_diff = resolution_levels - latent_levels
        self.image_size = tuple(image_size)
        self.dtype = dtype
        common = dict(n0=n0, resolution_levels=resolution_levels, norm=norm, dtype=dtype)
        lat = dict(zdim0=zdim0, latent_levels=latent_levels, **common)
        self.posterior = PhiSegPosterior(image_channels, nlabels, **lat)
        self.prior = PhiSegPrior(image_channels, **lat)
        self.likelihood = PhiSegLikelihood(nlabels=nlabels, image_size=image_size, **lat)

    def forward(self, x: torch.Tensor, s_oh: torch.Tensor,
                eps: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> ModelOutputs:
        """Training forward: posterior sample, teacher-forced prior, likelihood
        on the posterior z's (ref segvae.py:117-134).

        x: (B,H,W,Cin); s_oh: (B,H,W,nlabels). `eps` optionally injects the
        posterior's noise per level, NHWC like z; else it is drawn from
        `generator`.
        """
        eps_nchw = None if eps is None else [nchw(e) for e in eps]
        z, q_mu, q_sigma = self.posterior(nchw(x), nchw(s_oh), eps=eps_nchw, generator=generator)
        # Teacher-forced prior: its chain consumes the POSTERIOR's samples
        # (ref priors.py:126, phiseg_model.py:48-59).
        _, p_mu, p_sigma = self.prior(nchw(x), z_teacher=z)
        s_out = self.likelihood(z)
        return ModelOutputs(
            s_out_list=tuple(nhwc(t) for t in s_out),
            z=tuple(nhwc(t) for t in z),
            q_mu=tuple(nhwc(t) for t in q_mu),
            q_sigma=tuple(nhwc(t) for t in q_sigma),
            p_mu=tuple(nhwc(t) for t in p_mu),
            p_sigma=tuple(nhwc(t) for t in p_sigma),
        )

    # -- inference sampling (encode once, draw many) ------------------------

    def latent_shapes(self, batch: int) -> Tuple[Tuple[int, int, int, int], ...]:
        """NHWC shape of z at each latent level, finest first: the image
        halved (SAME pooling rounds up) i + R - L times."""
        shapes = []
        h, w = self.image_size
        for _ in range(self.lvl_diff):
            h, w = -(-h // 2), -(-w // 2)
        for _ in range(self.latent_levels):
            shapes.append((batch, h, w, self.zdim0))
            h, w = -(-h // 2), -(-w // 2)
        return tuple(shapes)

    def sample_cache(self, x: torch.Tensor):
        """(prior encoder features, likelihood features) of x (B,H,W,Cin)."""
        return self.prior.encode(nchw(x)), self.likelihood.features(x)

    def repeat_cache(self, cache, n: int):
        """The cache for n draws per image: row s*B + b holds image b. The
        prior's heads read only the features at levels >= R-L, so only those
        are tiled."""
        prior_cache, lik_cache = cache
        tiled = tuple(None if i < self.lvl_diff else t.repeat(n, 1, 1, 1)
                      for i, t in enumerate(prior_cache))
        return tiled, lik_cache

    def decode_sample(self, cache, eps: Optional[Sequence[torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None) -> ZTuple:
        """One prior draw per cache row -> per-level f32 logits, NHWC."""
        prior_cache, lik_cache = cache
        eps_nchw = None if eps is None else [nchw(e) for e in eps]
        z, _, _ = self.prior.heads(prior_cache, eps=eps_nchw, generator=generator)
        return tuple(nhwc(t) for t in self.likelihood.from_features(lik_cache, z))

    def sample_logits(self, x: torch.Tensor, eps: Optional[Sequence[torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Single-sample aggregated logits (ref s_out_eval, phiseg_model.py:107)."""
        return aggregate_levels(self.decode_sample(self.sample_cache(x), eps, generator))

    # -- auxiliary APIs mirrored from the reference engine -------------------

    def prior_draw(self, x: torch.Tensor, eps: Optional[Sequence[torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None):
        """Prior (z, mu, sigma), NHWC (ref generate_prior_samples :325-334)."""
        eps_nchw = None if eps is None else [nchw(e) for e in eps]
        out = self.prior(nchw(x), eps=eps_nchw, generator=generator)
        return tuple(tuple(nhwc(t) for t in part) for part in out)

    def posterior_draw(self, x: torch.Tensor, s_oh: torch.Tensor,
                       eps: Optional[Sequence[torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None):
        """Posterior (z, mu, sigma), NHWC (ref generate_posterior_samples :484-495)."""
        eps_nchw = None if eps is None else [nchw(e) for e in eps]
        out = self.posterior(nchw(x), nchw(s_oh), eps=eps_nchw, generator=generator)
        return tuple(tuple(nhwc(t) for t in part) for part in out)

    def decode_z(self, z: Sequence[torch.Tensor]) -> ZTuple:
        """Decode given latents, NHWC (ref generate_samples_from_z :313-322)."""
        return tuple(nhwc(t) for t in self.likelihood([nchw(t) for t in z]))
