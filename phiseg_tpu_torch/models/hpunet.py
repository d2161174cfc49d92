"""The Hierarchical Probabilistic U-Net (Kohl et al. 2019, "A Hierarchical
Probabilistic U-Net for Modeling Multi-Scale Segmentation Ambiguities",
arXiv:1905.13077), the family "hpu_net": deepmind-research
hierarchical_probabilistic_unet/model.py, class HierarchicalProbUNet with its
default arguments, and geco_utils.py for its objective (engine/objective.py
`geco_objective`).

Tensors inside are NCHW; convolutions run in the compute dtype with f32
parameters and no normalisation (ConvBlock with norm "none"); the Gaussian
heads' (mu, log sigma), the latents and the logits are f32.

  ResBlock          the pre-activated bottleneck block: relu, CONVS_PER_BLOCK
                    3x3 convs to d channels with a relu between them, a 1x1
                    conv d -> n, plus the input (a 1x1 conv of it where its
                    channels are not n);
  HPUNetCore        the prior's or the posterior's U-Net: an encoder of R
                    levels of BLOCKS_PER_LEVEL blocks (2x2 average pooling
                    between them) and a decoder truncated after L latent
                    levels. Decoder level i (counted from the coarsest, as
                    the source's loop counts) predicts a per-pixel Gaussian
                    from a 1x1 conv, draws z_i (or takes an injected one),
                    concatenates it to the features, upsamples x2 (nearest),
                    concatenates the encoder's features of that scale and
                    runs its blocks;
  StitchingDecoder  the levels the core's decoder leaves out, on the
                    prior's encoder features, and a 1x1 conv to the logits;
  HPUNet            the family as a SegVAE: a posterior core on concat(x,
                    one-hot s), a prior core on x, the stitching decoder as
                    its likelihood and GECO's state (`GecoState`).

Widths: c = n0 * (1, 2, 4, 8, 8, ...) over R levels, bottlenecks d = c / 2
(the published n0 = 24, R = 8, L = 4, zdim0 = 1, ExperimentConfig fields as
the other families use them). Latent tuples across the family's interface
are finest first, as every family's; the modules' own names (`dec{i}_*`)
count from the coarsest.

The published initialisers are orthogonal kernels at gain 1 and biases from
a normal truncated at two standard deviations of 0.001 (`init_hpunet_weights_`).
The source's l2(1e-5) regularisers on kernels and biases are left out, as
the other families' weight decay is (`weight_decay_weight` None).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from phiseg_tpu_torch.models.components import latent_map_shapes
from phiseg_tpu_torch.models.segvae import (
    ModelOutputs,
    SegVAE,
    ZTuple,
    check_image_size,
    draw_nhwc,
    latent_nchw,
    latents_nchw,
)
from phiseg_tpu_torch.nn.layers import (
    ConvBlock,
    at_least_f32,
    avg_pool_2x2,
    nchw,
    nhwc,
    upsample_nearest,
)
from phiseg_tpu_torch.utils.profiling import span

# HierarchicalProbUNet's defaults (model.py `loss_kwargs`, `convs_per_block`,
# `blocks_per_level`, `base_channels`)
TOP_K_SHARE = 0.02   # top_k_percentage: the share of a batch's pixels in the loss
KAPPA = 0.05         # the reconstruction threshold per selected pixel
DECAY = 0.99         # the moving average of the reconstruction loss
RATE = 1e-2          # the Lagrange multiplier's gradient is scaled by -RATE
LAGMUL_INIT = 1.0
CONVS_PER_BLOCK = 3
BLOCKS_PER_LEVEL = 3
BIAS_STD = 0.001     # truncated_normal_initializer(stddev=0.001)


def hpunet_channels(n0: int, resolution_levels: int) -> Tuple[int, ...]:
    """Channels per level: n0 * (1, 2, 4, 8, 8, ...)."""
    mults = (1, 2, 4) + (8,) * max(0, resolution_levels - 3)
    return tuple(n0 * m for m in mults[:resolution_levels])


def _conv(cin: int, cout: int, k: int, act, dtype: torch.dtype) -> ConvBlock:
    return ConvBlock(cin, cout, kernel_size=k, activation=act, norm="none", dtype=dtype)


class ResBlock(nn.Module):
    """unet_utils.res_block: out = skip(h) + proj(conv(relu(h))), where conv
    is CONVS_PER_BLOCK 3x3 convs to `d` channels with relus between them and
    proj a 1x1 conv to `n`; skip is h where it has n channels, else a 1x1
    conv of h."""

    def __init__(self, cin: int, n: int, d: int, dtype: torch.dtype):
        super().__init__()
        c = cin
        for k in range(CONVS_PER_BLOCK):
            last = k == CONVS_PER_BLOCK - 1
            self.add_module(f"conv{k}", _conv(c, d, 3, None if last else F.relu, dtype))
            c = d
        self.proj = _conv(d, n, 1, None, dtype)
        self.skip = None if cin == n else _conv(cin, n, 1, None, dtype)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        r = F.relu(h)
        for k in range(CONVS_PER_BLOCK):
            r = getattr(self, f"conv{k}")(r)
        r = self.proj(r)
        return (h if self.skip is None else self.skip(h)) + r


def _blocks(module: nn.Module, prefix: str, cin: int, n: int, dtype: torch.dtype) -> None:
    for b in range(BLOCKS_PER_LEVEL):
        module.add_module(f"{prefix}_block{b}", ResBlock(cin if b == 0 else n, n, n // 2, dtype))


def _run_blocks(module: nn.Module, prefix: str, h: torch.Tensor) -> torch.Tensor:
    for b in range(BLOCKS_PER_LEVEL):
        h = getattr(module, f"{prefix}_block{b}")(h)
    return h


class HPUNetCore(nn.Module):
    """model.py `_HierarchicalCore`: the encoder and the truncated decoder
    with its latents."""

    def __init__(self, in_features: int, zdim0: int, n0: int, latent_levels: int,
                 resolution_levels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        R, L = resolution_levels, latent_levels
        if not 1 <= L <= R - 1:
            raise ValueError(f"HPU-Net needs 1 <= latent_levels <= resolution_levels - 1, "
                             f"not L={L}, R={R}")
        self.R, self.L, self.zdim0, self.dtype = R, L, zdim0, dtype
        ch = hpunet_channels(n0, R)
        cin = in_features
        for lvl in range(R):
            _blocks(self, f"enc{lvl}", cin, ch[lvl], dtype)
            cin = ch[lvl]
        f = ch[R - 1]
        for i in range(L):
            self.add_module(f"dec{i}_head", _conv(f, 2 * zdim0, 1, None, dtype))
            _blocks(self, f"dec{i}", zdim0 + f + ch[R - 2 - i], ch[R - 2 - i], dtype)
            f = ch[R - 2 - i]

    def latent_shapes(self, batch: int, image_size: Tuple[int, int]):
        """z's NHWC shape at each latent level, finest first: the image
        halved R - L + i times at level i."""
        return latent_map_shapes(batch, image_size, self.R - self.L, self.L, self.zdim0)

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The encoder's output at every level, finest first."""
        feats = []
        h = x.to(self.dtype)
        for lvl in range(self.R):
            if lvl > 0:
                h = avg_pool_2x2(h)
            h = _run_blocks(self, f"enc{lvl}", h)
            feats.append(h)
        return tuple(feats)

    def decode(self, enc: Sequence[torch.Tensor], eps: Optional[Sequence[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None,
               z_inject: Optional[Sequence[torch.Tensor]] = None, features: bool = True):
        """(features, z, mu, sigma) from the encoder's features: the latent
        tuples finest first, NCHW, f32. z_i = mu_i + sigma_i eps_i with eps
        injected (finest first, like z) or drawn from `generator` in the
        compute dtype, coarsest first; with `z_inject` (the posterior's z,
        finest first) nothing is drawn. Without `features` the blocks after
        the last draw are not run (the posterior's, which nothing reads;
        the source's graph prunes them) and the features are None."""
        R, L, zd = self.R, self.L, self.zdim0
        f = enc[R - 1]
        zs: List[torch.Tensor] = []
        mus: List[torch.Tensor] = []
        sigmas: List[torch.Tensor] = []
        for i in range(L):
            ms = at_least_f32(getattr(self, f"dec{i}_head")(f))
            mu, sigma = ms[:, :zd], torch.exp(ms[:, zd:])
            if z_inject is not None:
                z = z_inject[L - 1 - i]
            else:
                e = eps[L - 1 - i] if eps is not None else torch.randn(
                    mu.shape, dtype=self.dtype, device=mu.device, generator=generator)
                z = mu + sigma * e.to(mu.dtype)
            zs.append(z)
            mus.append(mu)
            sigmas.append(sigma)
            if not features and i == L - 1:
                f = None
                break
            f = upsample_nearest(torch.cat([z.to(self.dtype), f], dim=1), 2)
            f = _run_blocks(self, f"dec{i}", torch.cat([f, enc[R - 2 - i]], dim=1))
        return f, tuple(zs[::-1]), tuple(mus[::-1]), tuple(sigmas[::-1])

    def forward(self, x: torch.Tensor, eps: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None):
        """(z, mu, sigma) of the input (x, or the posterior's concat(x, s)),
        finest first, as the other families' priors and posteriors give them."""
        _, z, mu, sigma = self.decode(self.encode(x), eps, generator, features=False)
        return z, mu, sigma


class StitchingDecoder(nn.Module):
    """model.py `_StitchingDecoder`: levels L+1 .. R-1 of the U-Net's
    decoder on the prior's encoder features, then the 1x1 logits conv."""

    def __init__(self, nlabels: int, n0: int, latent_levels: int, resolution_levels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        R, L = resolution_levels, latent_levels
        self.R, self.L = R, L
        ch = hpunet_channels(n0, R)
        f = ch[R - 1 - L]
        for lvl in range(L + 1, R):
            c = ch[R - 1 - lvl]
            _blocks(self, f"level{lvl}", f + c, c, dtype)
            f = c
        self.logits = _conv(ch[0], nlabels, 1, None, dtype)

    def forward(self, enc: Sequence[torch.Tensor], f: torch.Tensor) -> torch.Tensor:
        """The f32 logits (B, nlabels, H, W)."""
        for lvl in range(self.L + 1, self.R):
            f = torch.cat([upsample_nearest(f, 2), enc[self.R - 1 - lvl]], dim=1)
            f = _run_blocks(self, f"level{lvl}", f)
        return at_least_f32(self.logits(f))


class GecoState(nn.Module):
    """GECO's state: the Lagrange multiplier `lagmul` (a parameter, stepped
    by the model's optimiser with its gradient scaled by -RATE and clamped
    at >= 0 after each step) and the zero-debiased moving average of the
    reconstruction loss (`ma_hidden`, `ma_count`), as buffers, so that the
    state dict, checkpoints and resume carry all three."""

    def __init__(self):
        super().__init__()
        self.lagmul = nn.Parameter(torch.tensor(LAGMUL_INIT))
        self.register_buffer("ma_hidden", torch.zeros(()))
        self.register_buffer("ma_count", torch.zeros((), dtype=torch.int64))

    def multiplier(self) -> torch.Tensor:
        """lagmul in the loss: its value, with the gradient scaled by -RATE
        (gradient ascent on the constraint)."""
        lam = self.lagmul.clone()
        if lam.requires_grad:
            lam.register_hook(lambda g: g * -RATE)
        return lam

    def moving_average(self, value: torch.Tensor, update: bool) -> torch.Tensor:
        """The zero-debiased average of `value` over the steps, this one
        included; its gradient is value's. Written to the buffers when
        `update` (a train step), else only read."""
        v = value.detach().to(self.ma_hidden.dtype)
        hidden = DECAY * self.ma_hidden + (1.0 - DECAY) * v
        count = self.ma_count + 1
        if update:
            self.ma_hidden.copy_(hidden)
            self.ma_count.copy_(count)
        average = hidden / (1.0 - torch.pow(DECAY, count.to(hidden.dtype)))
        return average.to(value.dtype) + value - value.detach()

    @torch.no_grad()
    def clamp_(self) -> None:
        self.lagmul.clamp_(min=0.0)


def init_hpunet_weights_(module: nn.Module, generator: torch.Generator) -> None:
    """The published initialisers, from `generator`: every conv kernel
    orthogonal at gain 1 (torch's orthogonal_ over the (out, in * k * k)
    matrix: TF's orthogonal_initializer over (k * k * in, out), transposed),
    every bias from a normal of std BIAS_STD truncated at two of them; the
    multiplier LAGMUL_INIT and the moving average empty."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, ConvBlock):
                nn.init.orthogonal_(m.conv.weight, gain=1.0, generator=generator)
                nn.init.trunc_normal_(m.conv.bias, std=BIAS_STD, a=-2 * BIAS_STD,
                                      b=2 * BIAS_STD, generator=generator)
            elif isinstance(m, GecoState):
                m.lagmul.fill_(LAGMUL_INIT)
                m.ma_hidden.zero_()
                m.ma_count.zero_()


class HPUNet(SegVAE):
    """The family "hpu_net" behind SegVAE's interface. Its z are NHWC maps at
    its L coarsest scales; its one level of logits comes from a decoder that
    runs to full resolution for every draw, so its sampling cache is the
    prior's encoder features at every level, and the sampler tiles them all
    (SegVAE.repeat_cache)."""

    def __init__(self, model_family: str = "hpu_net", zdim0: int = 2, n0: int = 32,
                 latent_levels: int = 5, resolution_levels: int = 7, nlabels: int = 2,
                 image_size: Tuple[int, int] = (128, 128), norm: str = "none",
                 dtype: torch.dtype = torch.float32, image_channels: int = 1):
        nn.Module.__init__(self)  # SegVAE's constructor builds the JAX package's families
        check_image_size(image_size, resolution_levels)
        if norm != "none":
            raise ValueError(f"the HPU-Net has no normalisation: norm must be 'none', not {norm!r}")
        if any(side % 2 ** (resolution_levels - 1) for side in image_size):
            raise ValueError(f"the HPU-Net's nearest x2 upsampling needs image sides that "
                             f"2^(R-1) = {2 ** (resolution_levels - 1)} divides, not "
                             f"{tuple(image_size)}")
        self.model_family = model_family
        self.image_size = tuple(image_size)
        self.dtype = dtype
        lat = dict(zdim0=zdim0, n0=n0, latent_levels=latent_levels,
                   resolution_levels=resolution_levels, dtype=dtype)
        self.posterior = HPUNetCore(image_channels + nlabels, **lat)
        self.prior = HPUNetCore(image_channels, **lat)
        self.likelihood = StitchingDecoder(nlabels, n0, latent_levels, resolution_levels, dtype)
        self.geco = GecoState()

    def init_weights_(self, generator: torch.Generator) -> None:
        """The published initialisers, from `generator` (`init_hpunet_weights_`)."""
        init_hpunet_weights_(self, generator)

    def forward(self, x: torch.Tensor, s_oh: torch.Tensor,
                eps: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> ModelOutputs:
        """Training forward: the posterior core on concat(x, one-hot s) draws
        z; the prior core on x is teacher-forced with it and the stitching
        decoder reads the prior's encoder features (model.py `reconstruct`,
        `kl`)."""
        x_c = nchw(x)
        z, q_mu, q_sigma = self.posterior(torch.cat([x_c, nchw(s_oh)], dim=1),
                                          latents_nchw(eps), generator)
        enc = self.prior.encode(x_c)
        f, _, p_mu, p_sigma = self.prior.decode(enc, z_inject=z)
        logits = self.likelihood(enc, f)
        z, q_mu, q_sigma, p_mu, p_sigma = draw_nhwc((z, q_mu, q_sigma, p_mu, p_sigma))
        return ModelOutputs(s_out_list=(nhwc(logits),), z=z, q_mu=q_mu, q_sigma=q_sigma,
                            p_mu=p_mu, p_sigma=p_sigma)

    def sample_cache(self, x: torch.Tensor) -> ZTuple:
        """The prior's encoder features at every level of x (B,H,W,Cin)."""
        return self.prior.encode(nchw(x))

    def decode_sample(self, cache, eps: Optional[Sequence[torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None) -> ZTuple:
        """One prior draw per cache row -> the one level of f32 logits, NHWC,
        in two spans with CUDA events on the cache's device:
        `sample.decode.latents` (the prior core's latent levels) and
        `sample.decode.stitch` (the stitching decoder and its logits)."""
        with span("sample.decode.latents", device=cache[0].device):
            f, _, _, _ = self.prior.decode(cache, latents_nchw(eps), generator)
        with span("sample.decode.stitch", device=cache[0].device):
            return (nhwc(self.likelihood(cache, f)),)

    def posterior_draw(self, x: torch.Tensor, s_oh: torch.Tensor,
                       eps: Optional[Sequence[torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None):
        """Posterior (z, mu, sigma): the core reads concat(x, s)."""
        return draw_nhwc(self.posterior(torch.cat([nchw(x), nchw(s_oh)], dim=1),
                                        latents_nchw(eps), generator))

    def decode_z(self, z: Sequence[torch.Tensor], x: torch.Tensor) -> ZTuple:
        """Decode given latents with x (B,H,W,Cin), whose prior encoder
        features the decoder reads, NHWC."""
        enc = self.prior.encode(nchw(x))
        f, _, _, _ = self.prior.decode(enc, z_inject=[latent_nchw(t) for t in z])
        return (nhwc(self.likelihood(enc, f)),)
