"""The PHiSeg training objective (port of phiseg_tpu/engine/objective.py:31-136).

  * residual multinoulli loss: per-level softmax CE on the residually
    accumulated logits, coarsest -> finest (ref phiseg_model.py:229-262);
    through the fused CUDA kernels when enabled;
  * hierarchical KL: closed-form diagonal-Gaussian KL(q || p) per latent
    level, optionally 4^i weighted (:265-287);
  * optional L2 weight decay over the conv kernels (:290-300).

Loss-dict keys match the reference names. Under a mesh every entry is the
global-batch mean on every rank: the CE through K3 (`fused_residual_ce_dp`),
the KL levels through one all_reduce (ref phiseg_tpu/engine/objective.py:31-50,
where the means over a global array are global by construction).

The HPU-Net trains on `geco_objective` instead (deepmind-research
hierarchical_probabilistic_unet/model.py `loss`, geco_utils.py `ce_loss`),
with the constants of models/hpunet.py; SSN on `ssn_objective`
(biomedia-mira/stochastic_segmentation_networks ssn/loss.py), with those of
models/ssn.py.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.models.hpunet import KAPPA, TOP_K_SHARE
from phiseg_tpu_torch.models.segvae import ModelOutputs
from phiseg_tpu_torch.models.ssn import MC_SAMPLES, SSNOutputs
from phiseg_tpu_torch.nn.layers import at_least_f32
from phiseg_tpu_torch.nn.losses import kl_two_gauss_diag_cov
from phiseg_tpu_torch.ops.fused_residual_ce import (
    fused_residual_ce,
    fused_residual_ce_dp,
    residual_ce_plain,
)
from phiseg_tpu_torch.utils.profiling import span


def residual_multinoulli_loss(s_out_list: Sequence[torch.Tensor], s_oh: torch.Tensor,
                              use_fused: bool = False, mesh=None
                              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sum over levels of CE(accumulated logits, GT) (ref :241-262); the
    global-batch value under a mesh. The fused kernels read the model's level
    tensors in place."""
    if use_fused:
        if mesh is not None:
            per_level = fused_residual_ce_dp(s_out_list, s_oh, mesh)
        else:
            per_level = fused_residual_ce(s_out_list, s_oh)
    else:
        per_level = residual_ce_plain(s_out_list, s_oh)
        if mesh is not None:
            per_level = mesh.mean(per_level)
    loss_dict = {f"residual_multinoulli_loss_lvl{i}": per_level[i]
                 for i in range(len(s_out_list))}
    return per_level.sum(), loss_dict


def hierarchical_kl_loss(outputs: ModelOutputs, exponential_weighting: bool,
                         sigma_floor: Optional[float] = None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-level KL(q || p), optionally 4^i weighted (ref :265-287).

    sigma_floor (documented deviation of the JAX package, default None =
    reference-faithful): clamp both sigmas to at least this value inside
    the KL only.
    """
    latent_levels = len(outputs.q_mu)
    weights = [4.0 ** i if exponential_weighting else 1.0 for i in range(latent_levels)]
    clamp = (lambda s: torch.clamp(s, min=sigma_floor)) if sigma_floor else (lambda s: s)
    loss_dict: Dict[str, torch.Tensor] = {}
    total = None
    for i in reversed(range(latent_levels)):
        kl = weights[i] * kl_two_gauss_diag_cov(
            outputs.q_mu[i], clamp(outputs.q_sigma[i]),
            outputs.p_mu[i], clamp(outputs.p_sigma[i]),
        )
        loss_dict[f"KL_divergence_loss_lvl{i}"] = kl
        total = kl if total is None else total + kl
    return total, loss_dict


def weight_decay_loss(model: nn.Module) -> torch.Tensor:
    """L2 over the conv kernels, tf.nn.l2_loss = sum(x^2)/2 (ref :290-300).
    The kernels are the Flax `kernel` leaves, here `*.conv.weight`."""
    terms = [0.5 * torch.sum(torch.square(at_least_f32(p)))
             for name, p in model.named_parameters() if name.endswith("conv.weight")]
    return torch.stack(terms).sum()


def phiseg_objective(outputs: ModelOutputs, s_oh: torch.Tensor, cfg: ExperimentConfig,
                     model: Optional[nn.Module] = None, use_fused_ce: bool = False,
                     mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss + per-term dict (keys match ref loss_dict, :114-130).
    With a mesh (parallel.mesh.Mesh), every term is the global-batch mean."""
    loss_dict: Dict[str, torch.Tensor] = {}
    total = torch.zeros((), dtype=torch.float32, device=s_oh.device)

    if cfg.residual_multinoulli_loss_weight is not None:
        ce, ce_dict = residual_multinoulli_loss(outputs.s_out_list, s_oh, use_fused_ce, mesh)
        loss_dict.update(ce_dict)
        total = total + cfg.residual_multinoulli_loss_weight * ce

    if cfg.kl_divergence_loss_weight is not None and len(outputs.q_mu) > 0:
        kl, kl_dict = hierarchical_kl_loss(outputs, cfg.exponential_weighting,
                                           sigma_floor=cfg.kl_sigma_floor)
        if mesh is not None:
            keys = list(kl_dict)
            means = mesh.mean(torch.stack([kl_dict[k] for k in keys]))
            kl_dict = {k: means[i] for i, k in enumerate(keys)}
            kl = means.sum()
        loss_dict.update(kl_dict)
        total = total + cfg.kl_divergence_loss_weight * kl

    if cfg.weight_decay_weight is not None and model is not None:
        wd = cfg.weight_decay_weight * weight_decay_loss(model)
        loss_dict["weight_decay"] = wd
        total = total + wd

    loss_dict["total_loss"] = total
    return total, loss_dict


def top_k_mask(xe: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """geco_utils.ce_loss's mask over the flat pixels of a batch: 1 at the
    floor(TOP_K_SHARE * pixels) pixels of the largest log(xe / sum(xe)) +
    Gumbel noise, 0 elsewhere; xe is under stop-gradient. The Gumbel noise
    is -log(-log(u + 1e-20) + 1e-20) of one uniform a pixel, drawn from
    `generator` in xe's dtype and order."""
    sg = xe.detach()
    u = torch.rand(sg.shape, generator=generator, device=sg.device, dtype=sg.dtype)
    score = torch.log(sg / sg.sum()) - torch.log(-torch.log(u + 1e-20) + 1e-20)
    k = int(math.floor(sg.numel() * TOP_K_SHARE))
    return torch.zeros_like(sg).index_fill_(0, torch.topk(score, k, sorted=False).indices, 1.0)


def gauss_kl(mu0: torch.Tensor, sigma0: torch.Tensor, mu1: torch.Tensor,
             sigma1: torch.Tensor) -> torch.Tensor:
    """KL(N(mu0, sigma0^2) || N(mu1, sigma1^2)) of diagonal Gaussians,
    analytic (tfd.kl_divergence of two MultivariateNormalDiag), summed over
    the pixels and latent channels of each image, mean over the batch."""
    b = mu0.shape[0]
    mu0, sigma0, mu1, sigma1 = (at_least_f32(t).reshape(b, -1) for t in (mu0, sigma0, mu1, sigma1))
    per = (torch.log(sigma1) - torch.log(sigma0)
           + (sigma0.square() + (mu0 - mu1).square()) / (2.0 * sigma1.square()) - 0.5)
    return per.sum(dim=1).mean()


def geco_objective(outputs: ModelOutputs, s_oh: torch.Tensor, model: nn.Module,
                   generator: Optional[torch.Generator] = None, mesh=None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The HPU-Net's GECO loss lagmul * (ma(rec) - KAPPA * k/B) + KL and the
    source's summaries (model.py `loss`):

      rec_loss_sum      the batch mean of each image's CE summed over its
                        top-k pixels (top_k_mask over the whole batch);
      rec_loss_mean     that CE over the selected pixels, their mean;
      kl_{i}, kl_sum    each latent level's KL (i counts from the
                        coarsest, as the source's levels do) and their sum;
      ma_rec_loss_mean  the debiased moving average of rec_loss_sum over
                        num_valid_pixels, the selected pixels an image;
      lagmul            the multiplier before this step's update;
      total_loss        the loss.

    The moving average's buffers advance only in training mode (a train
    step), not in an eval loss. The top-k's uniforms come from `generator`
    after the forward's draws (span `train_step.geco` around the top-k, the
    moving average and the multiplier)."""
    if mesh is not None:
        raise NotImplementedError("the GECO objective runs on one rank's whole batch")
    logits = at_least_f32(outputs.s_out_list[0])
    b = logits.shape[0]
    xe = -(s_oh.to(logits.dtype) * F.log_softmax(logits, dim=-1)).sum(dim=-1).reshape(-1)
    L = len(outputs.q_mu)
    kls = {f"kl_{L - 1 - i}": gauss_kl(outputs.q_mu[i], outputs.q_sigma[i], outputs.p_mu[i],
                                       outputs.p_sigma[i]) for i in reversed(range(L))}
    kl_sum = torch.stack(list(kls.values())).sum()
    with span("train_step.geco"):
        mask = top_k_mask(xe, generator)
        masked = (mask * xe).reshape(b, -1)
        rec_sum = masked.sum(dim=1).mean()
        rec_mean = masked.sum() / mask.sum()
        num_valid = mask.reshape(b, -1).sum(dim=1).mean()
        geco = model.geco
        ma = geco.moving_average(rec_sum, update=model.training)
        constraint = ma - KAPPA * num_valid
        lagmul = geco.multiplier()
        total = lagmul * constraint + kl_sum
    loss_dict = {"rec_loss_sum": rec_sum, "rec_loss_mean": rec_mean, "kl_sum": kl_sum, **kls,
                 "ma_rec_loss_mean": ma / num_valid, "num_valid_pixels": num_valid,
                 "lagmul": lagmul, "total_loss": total}
    return total, loss_dict


def antithetic_logits(outputs: SSNOutputs, eps_d: torch.Tensor, eps_w: torch.Tensor
                      ) -> torch.Tensor:
    """The 2 K draws (2 K, B, N) of SSN's logits, class-major, of K noises
    eps_d (K, B, H, W, C) and eps_w (K, B, R): mu + r_k for k < K, then
    mu - r_k, where r_k = W eps_w,k + sqrt(D) eps_d,k."""
    mu, factor, diag = outputs.mean, outputs.cov_factor, outputs.cov_diag
    k, b = eps_w.shape[:2]
    noise_d = eps_d.to(mu.dtype).permute(0, 1, 4, 2, 3).reshape(k, b, -1)  # class-major, as mu
    r = torch.einsum("bnr,kbr->kbn", factor, eps_w.to(mu.dtype)) + diag.sqrt() * noise_d
    return torch.cat([mu + r, mu - r])


def ssn_objective(outputs: SSNOutputs, s_oh: torch.Tensor, model: nn.Module,
                  generator: Optional[torch.Generator] = None,
                  eps: Optional[Sequence[torch.Tensor]] = None, mesh=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """SSN's Monte Carlo loss over M = MC_SAMPLES draws of the logits, half
    of them antithetic (ssn/loss.py StochasticSegmentationNetworkLossMCIntegral
    with its fixed_re_parametrization_trick): r_m = W eps_W,m + sqrt(D)
    eps_D,m for m < M/2, eta_m = mu + r_m and eta_{m+M/2} = mu - r_m,
    log p_m(b) = -(the CE of eta_m against image b's labels, summed over its
    pixels), loss = -mean_b (logsumexp_m log p_m(b) - log M). There is no KL
    term. The summaries:

      ssn_loglik          the batch mean of logsumexp_m log p_m(b) - log M;
      ssn_ce_mean         the mean over the M draws and the batch of an
                          image's summed CE;
      ssn_cov_diag_mean   the mean of D;
      ssn_cov_factor_rms  the root mean square of W's entries;
      total_loss          the loss.

    The M/2 draws come from `generator` after the forward's (which draws
    none; in a train step, after the augmentation's): eps_D of (M/2, B, H,
    W, C), then eps_W of (M/2, B, R), in the model's compute dtype, the
    shapes of `model.latent_shapes(B)` with a leading M/2. `eps` = (eps_D,
    eps_W) of those shapes injects them instead. The draw is written out,
    with no torch.distributions object, whose constructor factorises the
    capacitance matrix with a check that waits for the host, so that the
    step stays one CUDA graph. Span `train_step.ssn_loss` around it all."""
    if mesh is not None:
        raise NotImplementedError("the SSN objective runs on one rank's whole batch")
    mu, factor, diag = outputs.mean, outputs.cov_factor, outputs.cov_diag
    b = mu.shape[0]
    half = MC_SAMPLES // 2
    with span("train_step.ssn_loss"):
        if eps is None:
            eps = [torch.randn((half, *shape), generator=generator, device=mu.device,
                               dtype=model.dtype) for shape in model.latent_shapes(b)]
        c = s_oh.shape[-1]
        logits = antithetic_logits(outputs, *eps).reshape(MC_SAMPLES, b, c, -1)
        labels = s_oh.to(mu.dtype).permute(0, 3, 1, 2).reshape(b, c, -1)
        ce = -(labels * F.log_softmax(logits, dim=2)).sum(dim=(2, 3))  # (M, B)
        loglik = torch.logsumexp(-ce, dim=0) - math.log(MC_SAMPLES)
        total = -loglik.mean()
    loss_dict = {"ssn_loglik": loglik.mean(), "ssn_ce_mean": ce.mean(),
                 "ssn_cov_diag_mean": diag.mean(),
                 "ssn_cov_factor_rms": factor.square().mean().sqrt(), "total_loss": total}
    return total, loss_dict
