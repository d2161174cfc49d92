"""Stochastic Segmentation Networks (Monteiro et al. 2020, "Stochastic
Segmentation Networks: Modelling Spatially Correlated Aleatoric
Uncertainty", arXiv:2006.06015), the family "ssn":
biomedia-mira/stochastic_segmentation_networks, ssn/ssn.py
(StochasticSegmentationNetwork) on PHiSeg-code's deterministic U-Net, and
ssn/loss.py (StochasticSegmentationNetworkLossMCIntegral) for its objective
(engine/objective.py `ssn_objective`).

The logits of an image, flattened class-major over (C, H, W) to N = C H W,
are one Gaussian draw

    eta ~ N(mu, W W^T + diag(D)),   eta = mu + W eps_W + sqrt(D) * eps_D,

eps_W ~ N(0, I_R), eps_D ~ N(0, I_N) (what LowRankMultivariateNormal.rsample
computes), and the probabilities are the softmax over C at each pixel. mu,
W (N x R) and D come from three 1x1 convs with bias and no norm or
activation on the backbone's features h (the deterministic U-Net's UNetCore
and its three `recomb` blocks, without the `prediction` conv; h is ReLU'd
already, so the source's relu on it changes nothing):

  mean          h -> C channels:     mu
  log_cov_diag  h -> C channels:     D = exp(l) + EPS, then D * mask + EPS with
                                     the mask 1 at every pixel (every pixel of a
                                     LIDC crop is inside the region of
                                     interest): exp(l) + EPS + EPS
  cov_factor    h -> C R channels:   channel r C + c is W's column r at class c
                                     (rank-major)

R, the rank, is the config's zdim0: eps_W is SSN's one latent of R
dimensions. Tensors inside are NCHW; the convolutions run in the compute
dtype with f32 parameters; mu, W, D, the draws' arithmetic, softmax and the
loss are f32. The network runs once an image, whatever the number of draws:
the sampler's cache is (mu, W, D) of the B images, which `repeat_cache` does
not copy, and `decode_sample` draws every row from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from phiseg_tpu_torch.models.families import UNetRecomb
from phiseg_tpu_torch.models.segvae import ModelOutputs, SegVAE, ZTuple, check_image_size
from phiseg_tpu_torch.nn.layers import ConvBlock, at_least_f32, nchw, nhwc
from phiseg_tpu_torch.utils.profiling import span

# ssn/ssn.py and ssn/loss.py, the repository's LIDC jobs
MC_SAMPLES = 20  # the loss's Monte Carlo samples, half of them antithetic
EPS = 1e-5       # added to the diagonal twice: after the exp and after the mask

Cache = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SSNOutputs(ModelOutputs):
    """SSN's training forward: the logits' distribution, class-major and
    f32, mean (B, N), cov_factor W (B, N, R) and cov_diag D (B, N); as
    ModelOutputs, the mean's logits NHWC as the one level of s_out_list
    (the diagnostics' prediction) and no latent parameters."""

    mean: Optional[torch.Tensor] = None
    cov_factor: Optional[torch.Tensor] = None
    cov_diag: Optional[torch.Tensor] = None


def _head(cin: int, cout: int, dtype: torch.dtype) -> ConvBlock:
    return ConvBlock(cin, cout, kernel_size=1, activation=None, norm="none", dtype=dtype)


def _pixel_major(t: torch.Tensor, classes: int, pixels: int) -> torch.Tensor:
    """(B, C H W, ...) class-major -> (B, H W C, ...) pixel-major, the
    order of an NHWC map."""
    b, rest = t.shape[0], t.shape[2:]
    return t.reshape(b, classes, pixels, *rest).transpose(1, 2).reshape(b, pixels * classes, *rest)


class SSNLikelihood(UNetRecomb):
    """The backbone and SSN's three heads; forward(x NCHW) -> (mean, W, D),
    class-major and f32."""

    def __init__(self, image_channels: int, n0: int, resolution_levels: int, nlabels: int,
                 rank: int, norm: str = "batch", dtype: torch.dtype = torch.float32):
        super().__init__(image_channels, n0, resolution_levels, 0, norm, dtype)
        self.rank = rank
        self.mean = _head(n0, nlabels, dtype)
        self.log_cov_diag = _head(n0, nlabels, dtype)
        self.cov_factor = _head(n0, nlabels * rank, dtype)

    def forward(self, x: torch.Tensor) -> Cache:
        h = self.recomb(self.unet(x.to(self.dtype)))
        b = h.shape[0]
        mean = at_least_f32(self.mean(h)).reshape(b, -1)
        cov_diag = torch.exp(at_least_f32(self.log_cov_diag(h))).reshape(b, -1) + EPS + EPS
        # (B, R C, H, W) -> (B, R, C H W) -> (B, N, R)
        cov_factor = at_least_f32(self.cov_factor(h)).reshape(b, self.rank, -1).transpose(1, 2)
        return mean, cov_factor, cov_diag


class SSN(SegVAE):
    """The family "ssn" behind SegVAE's interface. Its latents are the
    sampler's two noises, finest first and channels last: eps_D (B, H, W,
    C), one a logit, and eps_W (B, R). Its training forward returns
    SSNOutputs; the Monte Carlo loss draws (engine/objective.py). Its
    network runs once a sampler call, at the batch's B rows, and no network
    decodes the draws: the host's dispatch of the U-Net and of the eval's
    metrics sets the eval's pace, so the samplers replay both from CUDA
    graphs on the card (`replay_sampler`, engine/replay_graph.py)."""

    replay_sampler = True

    def __init__(self, model_family: str = "ssn", zdim0: int = 10, n0: int = 32,
                 latent_levels: int = 1, resolution_levels: int = 7, nlabels: int = 2,
                 image_size: Tuple[int, int] = (128, 128), norm: str = "batch",
                 dtype: torch.dtype = torch.float32, image_channels: int = 1):
        nn.Module.__init__(self)  # SegVAE's constructor builds the JAX package's families
        check_image_size(image_size, resolution_levels)
        if nlabels < 2 or zdim0 < 1:
            raise ValueError(f"SSN needs nlabels >= 2 and a rank zdim0 >= 1, not {nlabels}, "
                             f"{zdim0}")
        del latent_levels  # one latent, eps_W
        self.model_family = model_family
        self.image_size = tuple(image_size)
        self.dtype = dtype
        self.nlabels, self.rank = nlabels, zdim0
        self.likelihood = SSNLikelihood(image_channels, n0, resolution_levels, nlabels, zdim0,
                                        norm, dtype)

    def forward(self, x: torch.Tensor, s_oh: torch.Tensor,
                eps: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> SSNOutputs:
        """Training forward of x (B,H,W,Cin): the distribution of the
        logits. It draws nothing and reads neither s_oh, eps nor generator:
        the objective draws."""
        mean, cov_factor, cov_diag = self.likelihood(nchw(x))
        h, w = self.image_size
        logits = nhwc(mean.reshape(mean.shape[0], self.nlabels, h, w))
        return SSNOutputs(s_out_list=(logits,), z=(), q_mu=(), q_sigma=(), p_mu=(), p_sigma=(),
                          mean=mean, cov_factor=cov_factor, cov_diag=cov_diag)

    def latent_shapes(self, batch: int) -> Tuple[Tuple[int, ...], ...]:
        """eps_D's (B, H, W, C) and eps_W's (B, R)."""
        h, w = self.image_size
        return (batch, h, w, self.nlabels), (batch, self.rank)

    def sample_cache(self, x: torch.Tensor) -> Cache:
        """(mean, W, D) of x (B,H,W,Cin), class-major and f32."""
        return self.likelihood(nchw(x))

    def repeat_cache(self, cache: Cache, n: int) -> Cache:
        """The cache itself: decode_sample broadcasts its B rows over the
        draws, where tiling would copy W to n B rows."""
        del n
        return cache

    def decode_sample(self, cache: Cache, eps: Optional[Sequence[torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None) -> ZTuple:
        """The logits of S draws an image, one level of f32 (S B, H, W, C),
        row s B + b of image b: eta = mu + W eps_W + sqrt(D) eps_D, with
        eps (eps_D (S B, H, W, C), eps_W (S B, R)), else one draw an image
        from `generator`. W eps_W + mu is one batched GEMM over the images,
        pixel-major. Span `sample.decode.lowrank`, with CUDA events on the
        cache's device."""
        mean, cov_factor, cov_diag = cache
        b, dev = mean.shape[0], mean.device
        h, w = self.image_size
        c, hwc = self.nlabels, mean.shape[1]
        with span("sample.decode.lowrank", device=dev):
            if eps is None:
                eps = [torch.randn(shape, generator=generator, device=dev, dtype=self.dtype)
                       for shape in self.latent_shapes(b)]
            eps_d, eps_w = eps
            s = eps_w.shape[0] // b
            mu, factor, scale = (_pixel_major(t, c, h * w)
                                 for t in (mean, cov_factor, cov_diag.sqrt()))
            rows = eps_w.reshape(s, b, self.rank).transpose(0, 1).to(mean.dtype)  # (B, S, R)
            draws = torch.baddbmm(mu[:, None], rows, factor.transpose(1, 2))     # (B, S, HWC)
            eta = (scale * eps_d.reshape(s, b, hwc)).add_(draws.transpose(0, 1))
            return (eta.reshape(s * b, h, w, c),)

    def prior_draw(self, x: torch.Tensor, eps: Optional[Sequence[torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None):
        """(z, mu, sigma) of the two noises, whose prior is the standard
        normal whatever x: z is `eps` or a draw from `generator`."""
        z = tuple(eps) if eps is not None else tuple(
            torch.randn(shape, generator=generator, device=x.device, dtype=self.dtype)
            for shape in self.latent_shapes(x.shape[0]))
        return z, tuple(torch.zeros_like(t) for t in z), tuple(torch.ones_like(t) for t in z)

    def posterior_draw(self, x, s_oh, eps=None, generator=None):
        raise NotImplementedError("SSN has no posterior: its loss integrates over the prior's "
                                  "draws")

    def decode_z(self, z: Sequence[torch.Tensor], x: torch.Tensor) -> ZTuple:
        """The logits of given noises (eps_D, eps_W) with x (B,H,W,Cin), NHWC."""
        return self.decode_sample(self.sample_cache(x), eps=z)
