"""Validation: S prior draws, Dice / GED^2 / S_NCC per image, and the
eval-mode ELBO (port of phiseg_tpu/engine/validation.py:44-159).

Equivalent of the reference validation pass (phiseg/phiseg_model.py:530-701).
Both functions encode the batch once and decode the S draws as one S x B
batch (engine.train.make_sample_fn), in eval batch-norm mode, without
autograd. The ELBO averages `validation_elbo_samples` posterior draws of
the eval-mode loss (engine.train.make_eval_loss_fn), one forward of the
batch at a time, so memory stays at one forward; its CE goes through K1 by
the train step's rule.

Noise comes from `generator`, or is injected: `eps_samples` per latent
level (S, B, h, w, zdim) as make_sample_fn takes it, `eps_elbo` per level
(E, B, h, w, zdim), draw k using row k. The tests inject JAX's threefry
draws that way.

Spans (utils/profiling.span), their unit each function's call count:
`eval.sample` (the draws) and `eval.metrics` (GED^2's terms and S_NCC),
with CUDA events on x's device; `validation.sample`, `validation.metrics`
(Dice, GED^2, S_NCC) and `validation.elbo`.

The JAX package pads every batch to one shape (`pad_to_batch`) to avoid an
XLA recompile; eager PyTorch has nothing to recompile, so a short last batch
is simply smaller.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple

import torch

from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.replay_graph import ReplayGraph
from phiseg_tpu_torch.engine.train import make_eval_loss_fn, make_sample_fn, replays_sampler
from phiseg_tpu_torch.metrics import (
    dice_per_label,
    ged_terms,
    generalised_energy_distance,
    variance_ncc_dist,
)
from phiseg_tpu_torch.models.segvae import SegVAE
from phiseg_tpu_torch.nn.losses import one_hot
from phiseg_tpu_torch.utils.profiling import span

Eps = Optional[Sequence[torch.Tensor]]


def _draws_by_image(probs: torch.Tensor):
    """(S,B,H,W,C) probabilities -> (B,S,H,W,C) and their (B,S,H,W) masks."""
    probs_b = probs.transpose(0, 1)
    return probs_b, probs_b.argmax(-1)


def make_quant_eval_fn(model: SegVAE, cfg: ExperimentConfig, num_samples: int, mesh=None):
    """Build quant(x, s_annotators, generator=None, eps=None) ->
    (ged (B,), sncc (B,), ged_terms (B, 3)).

    The quantitative-eval workload (ref phiseg_test_quantitative.py:39-66)
    without validation's Dice and ELBO. x: (B,H,W,Cin); s_annotators:
    (B,M,H,W). ged_terms are (d_sy, d_ss, d_yy) of the same pairwise
    distances, GED^2 = 2*d_sy - d_ss - d_yy. With a mesh, each rank decodes
    its share of the draws and every rank computes the metrics on all of
    them. For a model with `replay_sampler` set (SSN) the metrics stage, as
    the sampler's encoder, is replayed from a CUDA graph on the card
    (engine/replay_graph.py).
    """
    nlabels = cfg.nlabels
    label_range = tuple(range(1, nlabels))
    sample = make_sample_fn(model, num_samples, mesh=mesh)
    calls = itertools.count()

    def metrics(probs: torch.Tensor, s_annotators: torch.Tensor):
        probs_b, masks_b = _draws_by_image(probs)
        d_sy, d_ss, d_yy = ged_terms(masks_b, s_annotators, nlabels=nlabels - 1,
                                     label_range=label_range)
        ged_b = 2.0 * d_sy - d_ss - d_yy
        sncc_b = variance_ncc_dist(probs_b, one_hot(s_annotators, nlabels))
        return ged_b, sncc_b, torch.stack([d_sy, d_ss, d_yy], dim=-1)

    score = ReplayGraph(metrics) if replays_sampler(model) else metrics

    def quant(x: torch.Tensor, s_annotators: torch.Tensor,
              generator: Optional[torch.Generator] = None, eps: Eps = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        unit = next(calls)
        with span("eval.sample", unit, x.device):
            probs = sample(x, generator, eps)
        with span("eval.metrics", unit, x.device):
            with torch.no_grad():
                return score(probs, s_annotators)

    return quant


def make_validation_fn(model: SegVAE, cfg: ExperimentConfig):
    """Build validate(x, s_annotators, s_selected, generator=None,
    eps_samples=None, eps_elbo=None) -> (dice (B, nlabels), ged (B,),
    sncc (B,), elbo scalar).

    x: (B,H,W,Cin) images; s_annotators: (B,M,H,W) every annotation;
    s_selected: (B,H,W) the annotation picked at random for Dice and the
    ELBO (ref :575, :600-613). The prior draws come first from `generator`,
    then the ELBO's posterior draws. The objective runs without a mesh: K3
    all-reduces, and under a mesh validation runs on rank 0 alone.
    """
    num_samples = cfg.validation_samples
    num_elbo = cfg.validation_elbo_samples
    nlabels = cfg.nlabels
    label_range = tuple(range(1, nlabels))
    sample = make_sample_fn(model, num_samples)
    eval_loss = make_eval_loss_fn(model, cfg)
    calls = itertools.count()

    def validate(x: torch.Tensor, s_annotators: torch.Tensor, s_selected: torch.Tensor,
                 generator: Optional[torch.Generator] = None, eps_samples: Eps = None,
                 eps_elbo: Eps = None):
        unit = next(calls)
        with span("validation.sample", unit):
            probs = sample(x, generator, eps_samples)  # (S,B,H,W,C)
        with span("validation.metrics", unit):
            probs_b, masks_b = _draws_by_image(probs)
            # mean-softmax argmax prediction (ref :587, :600)
            pred = probs.mean(0).argmax(-1)
            dice_b = dice_per_label(pred, s_selected, nlabels)
            ged_b = generalised_energy_distance(masks_b, s_annotators, nlabels=nlabels - 1,
                                                label_range=label_range)
            sncc_b = variance_ncc_dist(probs_b, one_hot(s_annotators, nlabels))

        # the eval-mode ELBO averaged over posterior draws (ref :577-585)
        with span("validation.elbo", unit):
            total = torch.zeros((), dtype=torch.float32, device=x.device)
            for k in range(num_elbo):
                eps = None if eps_elbo is None else [e[k] for e in eps_elbo]
                total = total + eval_loss(x, s_selected, generator, eps)["total_loss"]
        return dice_b, ged_b, sncc_b, total / num_elbo

    return validate
