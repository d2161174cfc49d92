"""Uncertainty and segmentation metrics on tensors (port of
phiseg_tpu/metrics/metrics.py:28-181).

  generalised_energy_distance  GED^2 (ref utils.py:270-322)
  ged_terms                    its three mean terms
  variance_ncc_dist            S_NCC (ref utils.py:326-370)
  variance_ncc_maps            its two maps, E_ss and E_sy
  ncc                          (ref utils.py:103-118)
  population_std               its std, as numpy's and jnp's in f32
  dice_per_label               with the eval CLIs' edge cases

The JAX package vmaps its single-image functions over images; here every
function takes leading batch axes itself: masks (..., N, H, W) give
(..., N, M) distances and (...) GED^2, probabilities (..., N, H, W, C) give
(...) S_NCC.

Edge cases kept exactly (utils.py:283-288, phiseg_test_predictions.py:72-78):
both masks empty for a label -> IoU 1 (Dice 1), exactly one empty -> 0;
the IoU sum is divided by the `nlabels` argument, not len(label_range).

Precision is pinned whatever the caller's settings: the pairwise
intersections are pixel counts (up to H*W). Under bf16 autocast a plain
product of the masks returns them in bf16, which rounds counts above 256
(chip_smoke.py phase 9 measures the error at 128x128), so they are one f64
product per label outside autocast (exact below 2^53; TF32 touches only
f32), then f32 as in the JAX package. S_NCC's cross-entropy maps are
elementwise f32 sums outside autocast, so no matmul touches them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _binary_pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of two stacks of boolean masks, a (..., N, P) and
    b (..., M, P) -> (..., N, M) f32: both empty -> 1, one empty -> 0."""
    with torch.autocast(a.device.type, enabled=False):
        inter = torch.matmul(a.double(), b.double().transpose(-1, -2)).float()
    sa = a.sum(-1).float()[..., :, None]  # (..., N, 1)
    sb = b.sum(-1).float()[..., None, :]  # (..., 1, M)
    union = sa + sb - inter
    iou = inter / torch.clamp(union, min=1e-12)
    iou = torch.where((sa == 0) & (sb == 0), torch.ones_like(iou), iou)
    return torch.where((sa == 0) ^ (sb == 0), torch.zeros_like(iou), iou)


def pairwise_iou_distance(masks_a: torch.Tensor, masks_b: torch.Tensor,
                          label_range: Sequence[int],
                          nlabels_divisor: int | None = None) -> torch.Tensor:
    """d(s, y) = 1 - (1/nlabels) sum_l IoU_l(s, y) for every pair.

    masks_a: (..., N, H, W) int; masks_b: (..., M, H, W) int. Returns
    (..., N, M) f32. The sum is divided by `nlabels_divisor` (default
    len(label_range)), as the reference `dist_fct` (utils.py:272-292) divides
    by its `nlabels` argument.
    """
    if nlabels_divisor is None:
        nlabels_divisor = len(label_range)
    a_flat = masks_a.flatten(-2)
    b_flat = masks_b.flatten(-2)
    iou_sum = None
    for lbl in label_range:
        iou = _binary_pairwise_iou(a_flat == lbl, b_flat == lbl)
        iou_sum = iou if iou_sum is None else iou_sum + iou
    return 1.0 - iou_sum / float(nlabels_divisor)


def _default_range(nlabels: int, label_range):
    return tuple(range(nlabels)) if label_range is None else tuple(label_range)


def generalised_energy_distance(sample_arr: torch.Tensor, gt_arr: torch.Tensor, nlabels: int,
                                label_range: Sequence[int] | None = None) -> torch.Tensor:
    """GED^2 between N predicted and M ground-truth masks per image.

    sample_arr: (..., N, H, W) int; gt_arr: (..., M, H, W) int -> (...) f32.
    The reference's biased estimator, self pairs included (utils.py:294-322):
      (2/NM) sum d(s,y) - (1/N^2) sum d(s,s') - (1/M^2) sum d(y,y')
    """
    label_range = _default_range(nlabels, label_range)
    n, m = sample_arr.shape[-3], gt_arr.shape[-3]
    d_sy = pairwise_iou_distance(sample_arr, gt_arr, label_range, nlabels)
    d_ss = pairwise_iou_distance(sample_arr, sample_arr, label_range, nlabels)
    d_yy = pairwise_iou_distance(gt_arr, gt_arr, label_range, nlabels)
    return ((2.0 / (n * m)) * d_sy.sum((-2, -1))
            - (1.0 / n ** 2) * d_ss.sum((-2, -1))
            - (1.0 / m ** 2) * d_yy.sum((-2, -1)))


def ged_terms(sample_arr: torch.Tensor, gt_arr: torch.Tensor, nlabels: int,
              label_range: Sequence[int] | None = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three mean terms (d_sy, d_ss, d_yy) of the GED^2 estimator, each
    (...) f32, self pairs included; GED^2 = 2*d_sy - d_ss - d_yy. A
    diagnostic that separates misfit from over- or under-diversity."""
    label_range = _default_range(nlabels, label_range)
    n, m = sample_arr.shape[-3], gt_arr.shape[-3]
    d_sy = pairwise_iou_distance(sample_arr, gt_arr, label_range, nlabels).sum((-2, -1))
    d_ss = pairwise_iou_distance(sample_arr, sample_arr, label_range, nlabels).sum((-2, -1))
    d_yy = pairwise_iou_distance(gt_arr, gt_arr, label_range, nlabels).sum((-2, -1))
    return d_sy / (n * m), d_ss / n ** 2, d_yy / m ** 2


def population_std(x: torch.Tensor) -> torch.Tensor:
    """The std over the last axis as numpy and jnp take it in f32 (ddof 0):
    the mean of the squared deviations, so that deviations below ~1e-19
    square to 0 and a map that spreads by less has std 0. (torch.std on
    the CPU accumulates in f64 and keeps them.)"""
    return (x - x.mean(-1, keepdim=True)).square().mean(-1, keepdim=True).sqrt()


def ncc(a: torch.Tensor, v: torch.Tensor, zero_norm: bool = True) -> torch.Tensor:
    """Normalised cross-correlation of two maps (ref utils.py:103-118), over
    the last two axes of a and v (..., H, W) -> (...) f32, with
    population_std: 0/0 where either map's std is 0."""
    a = a.float().flatten(-2)
    v = v.float().flatten(-2)
    size = a.shape[-1]
    a_std = population_std(a)
    v_std = population_std(v)
    if zero_norm:
        a = (a - a.mean(-1, keepdim=True)) / (a_std * size)
        v = (v - v.mean(-1, keepdim=True)) / v_std
    else:
        a = a / (a_std * size)
        v = v / v_std
    return (a * v).sum(-1)


def variance_ncc_maps(sample_probs: torch.Tensor, gt_onehot: torch.Tensor):
    """The two maps whose NCC is S_NCC (utils.py:349-363), in f32.

    sample_probs: (..., N, H, W, C) softmax probabilities of N prior draws;
    gt_onehot: (..., M, H, W, C) one-hot annotations -> (E_ss (..., H, W),
    E_sy (..., M, H, W)): the pixelwise CE of the draws against their mean
    and against each annotation j. Where a map's std is 0 its NCC is 0/0.
    """
    eps = 1e-8
    with torch.autocast(sample_probs.device.type, enabled=False):
        probs = sample_probs.float()
        n = probs.shape[-4]
        # both maps contract log(s) over the draws first: sum_n log s_n
        log_sum = torch.log(probs + eps).sum(-4)              # (..., H, W, C)
        mean_seg = probs.mean(-4)                             # (..., H, W, C)
        e_ss = -(mean_seg * log_sum).sum(-1) / n              # (..., H, W)
        e_sy = -(gt_onehot.float() * log_sum.unsqueeze(-4)).sum(-1) / n  # (..., M, H, W)
        return e_ss, e_sy


def variance_ncc_dist(sample_probs: torch.Tensor, gt_onehot: torch.Tensor) -> torch.Tensor:
    """S_NCC: NCC between the sample-variance and sample-vs-GT error maps
    of variance_ncc_maps, the mean over annotators of ncc(E_ss, E_sy_j)
    (utils.py:326-370). Shapes as variance_ncc_maps's -> (...) f32.
    """
    e_ss, e_sy = variance_ncc_maps(sample_probs, gt_onehot)
    with torch.autocast(sample_probs.device.type, enabled=False):
        return ncc(e_ss.unsqueeze(-3), e_sy).mean(-1)


def dice_per_label(pred: torch.Tensor, gt: torch.Tensor, nlabels: int) -> torch.Tensor:
    """Per-label Dice of int masks (..., H, W) -> (..., nlabels) f32: both
    empty -> 1, exactly one empty -> 0 (phiseg_test_predictions.py:72-78)."""
    dices = []
    for lbl in range(nlabels):
        p = pred == lbl
        g = gt == lbl
        inter = (p & g).sum((-2, -1)).float()
        sp = p.sum((-2, -1)).float()
        sg = g.sum((-2, -1)).float()
        d = 2.0 * inter / torch.clamp(sp + sg, min=1e-12)
        d = torch.where((sp == 0) & (sg == 0), torch.ones_like(d), d)
        dices.append(torch.where((sp == 0) ^ (sg == 0), torch.zeros_like(d), d))
    return torch.stack(dices, dim=-1)
