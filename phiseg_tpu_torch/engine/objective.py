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
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.models.segvae import ModelOutputs
from phiseg_tpu_torch.nn.layers import at_least_f32
from phiseg_tpu_torch.nn.losses import kl_two_gauss_diag_cov
from phiseg_tpu_torch.ops.fused_residual_ce import (
    fused_residual_ce,
    fused_residual_ce_dp,
    residual_ce_plain,
)


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
