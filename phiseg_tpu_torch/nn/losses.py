"""Loss functions on the training path (port of phiseg_tpu/nn/losses.py:20-64).

Logits and one-hot labels keep the JAX layout: NHWC, class axis last.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from phiseg_tpu_torch.nn.layers import at_least_f32


def one_hot(labels: torch.Tensor, nlabels: int, dtype=torch.float32) -> torch.Tensor:
    """Integer label map -> one-hot with class axis last (ref phiseg_model.py:29)."""
    return F.one_hot(labels.long(), nlabels).to(dtype)


def softmax_xent_with_logits(labels_oh: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Per-element softmax cross-entropy over the last axis, in f32 (f64
    for f64 logits)."""
    logp = torch.log_softmax(at_least_f32(logits), dim=-1)
    return -torch.sum(labels_oh * logp, dim=-1)


def multinoulli_loss_with_logits(labels_oh: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Pixel-summed, batch-meaned softmax CE (ref phiseg_model.py:229-238)."""
    xent = softmax_xent_with_logits(labels_oh, logits)
    return torch.mean(torch.sum(xent.reshape(xent.shape[0], -1), dim=1))


def kl_two_gauss_diag_cov(mu0: torch.Tensor, sigma0: torch.Tensor,
                          mu1: torch.Tensor, sigma1: torch.Tensor) -> torch.Tensor:
    """KL(N(mu0, sigma0^2) || N(mu1, sigma1^2)) for diagonal covariance.

    The reference numerics (phiseg_model.py:210-226): squares first, +1e-10
    inside both logs and the denominator, sum over all non-batch dims, mean
    over the batch, all in f32 (f64 for f64 inputs).
    """
    b = mu0.shape[0]
    mu0 = at_least_f32(mu0).reshape(b, -1)
    mu1 = at_least_f32(mu1).reshape(b, -1)
    s0sq = torch.square(at_least_f32(sigma0).reshape(b, -1))
    s1sq = torch.square(at_least_f32(sigma1).reshape(b, -1))
    per_sample = 0.5 * torch.sum(
        (s0sq + torch.square(mu1 - mu0)) / (s1sq + 1e-10)
        + torch.log(s1sq + 1e-10)
        - torch.log(s0sq + 1e-10)
        - 1.0,
        dim=1,
    )
    return torch.mean(per_sample)
