"""Loss functions (port of phiseg_tpu/nn/losses.py): the training path's
(:20-64) and the library's Dice and cross-entropy losses (:73-128; ref
tfwrapper/losses.py:8-159), which no shipped configuration trains with.

Logits and one-hot labels keep the JAX layout: NHWC, class axis last. The
losses run in f32 (f64 for f64 inputs).
"""

from __future__ import annotations

from typing import Sequence

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


# ---------------------------------------------------------------------------
# Dice and cross-entropy losses of the op library (JAX losses.py:73-128)
# ---------------------------------------------------------------------------


def get_dice(logits: torch.Tensor, labels_oh: torch.Tensor, epsilon: float = 1e-10) -> torch.Tensor:
    """Per-(image, structure) soft Dice of the softmax probabilities, (B, C)
    (ref losses.py:8-47)."""
    probs = torch.softmax(at_least_f32(logits), dim=-1)
    b, c = probs.shape[0], probs.shape[-1]
    probs_f = probs.reshape(b, -1, c)
    labels_f = labels_oh.to(probs.dtype).reshape(b, -1, c)
    intersection = torch.sum(probs_f * labels_f, dim=1)
    return (2.0 * intersection) / (probs_f.sum(dim=1) + labels_f.sum(dim=1) + epsilon)


def dice_loss(logits: torch.Tensor, labels_oh: torch.Tensor, mode: str = "macro_robust",
              only_foreground: bool = False, epsilon: float = 1e-10) -> torch.Tensor:
    """1 - Dice: "micro" pools every pixel and class, "macro" averages the
    per-class Dice (over the batch first), "macro_robust" the per-image Dice
    (over the classes first) (ref losses.py:50-119)."""
    if mode == "micro":
        probs = torch.softmax(at_least_f32(logits), dim=-1)
        labels_f = labels_oh.to(probs.dtype)
        if only_foreground:
            probs, labels_f = probs[..., 1:], labels_f[..., 1:]
        intersection = torch.sum(probs * labels_f)
        return 1.0 - (2.0 * intersection) / (probs.sum() + labels_f.sum() + epsilon)
    dice_per = get_dice(logits, labels_oh, epsilon)  # (B, C)
    if only_foreground:
        dice_per = dice_per[:, 1:]
    if mode == "macro":
        return 1.0 - dice_per.mean(dim=0).mean()
    if mode == "macro_robust":
        return 1.0 - dice_per.mean(dim=1).mean()
    raise ValueError(f"unknown dice mode: {mode!r}")


def cross_entropy_loss(logits: torch.Tensor, labels_oh: torch.Tensor) -> torch.Tensor:
    """Mean softmax CE over every pixel (ref losses.py:123-131)."""
    return softmax_xent_with_logits(labels_oh, logits).mean()


def pixel_wise_cross_entropy_loss_weighted(logits: torch.Tensor, labels_oh: torch.Tensor,
                                           class_weights: Sequence[float]) -> torch.Tensor:
    """Pixel-wise CE weighted by the class of each pixel's label (ref
    losses.py:135-159)."""
    xent = softmax_xent_with_logits(labels_oh, logits)
    w = torch.as_tensor(class_weights, dtype=xent.dtype, device=xent.device)
    weight_map = torch.sum(labels_oh.to(xent.dtype) * w, dim=-1)
    return torch.mean(xent * weight_map)
