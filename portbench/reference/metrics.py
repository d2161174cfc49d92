"""Plain PyTorch reference of the evaluation metrics of the source
(phiseg/utils.py): the squared generalised energy distance GED^2 between
the prior samples' masks and the annotators' masks, and S_NCC, the
normalised cross-correlation between the samples' cross-entropy to their
mean and to each annotation. Computed in float64 from float32 probabilities.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of boolean masks a (N, P), b (M, P) -> (N, M): both empty 1,
    one empty 0 (utils.py dist_fct)."""
    a, b = a.double(), b.double()
    inter = a @ b.T
    sa, sb = a.sum(1)[:, None], b.sum(1)[None, :]
    iou = inter / (sa + sb - inter).clamp_min(1e-12)
    iou = torch.where((sa == 0) & (sb == 0), torch.ones_like(iou), iou)
    return torch.where((sa == 0) ^ (sb == 0), torch.zeros_like(iou), iou)


def _dist(a: torch.Tensor, b: torch.Tensor, labels: Sequence[int], divisor: int) -> torch.Tensor:
    total = sum(_iou(a == lbl, b == lbl) for lbl in labels)
    return 1.0 - total / divisor


def ged(masks: torch.Tensor, annotations: torch.Tensor, nlabels: int) -> torch.Tensor:
    """GED^2 of one image: masks (N, H, W), annotations (M, H, W), integer
    labels. The source's estimator with self pairs, over the foreground
    labels, each distance's IoU sum divided by nlabels - 1."""
    labels, div = range(1, nlabels), nlabels - 1
    s, y = masks.flatten(1), annotations.flatten(1)
    return (2.0 * _dist(s, y, labels, div).mean() - _dist(s, s, labels, div).mean()
            - _dist(y, y, labels, div).mean())


def _ncc(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Zero-normalised cross-correlation over the last axis, population std."""
    a = a - a.mean(-1, keepdim=True)
    v = v - v.mean(-1, keepdim=True)
    sa = a.square().mean(-1).sqrt()
    sv = v.square().mean(-1).sqrt()
    return (a * v).sum(-1) / (sa * sv * a.shape[-1])


def sncc(probs: torch.Tensor, annotations: torch.Tensor, nlabels: int) -> torch.Tensor:
    """S_NCC of one image: probs (N, H, W, C) of N draws, annotations
    (M, H, W). The mean over annotators j of ncc(E[CE(s, s_mean)], E[CE(s, y_j)])."""
    p = probs.double()
    n = p.shape[0]
    log_sum = torch.log(p + 1e-8).sum(0)                       # (H, W, C)
    e_ss = -(p.mean(0) * log_sum).sum(-1) / n                   # (H, W)
    y = torch.nn.functional.one_hot(annotations.long(), nlabels).double()
    e_sy = -(y * log_sum[None]).sum(-1) / n                     # (M, H, W)
    return _ncc(e_ss.flatten()[None], e_sy.flatten(1)).mean()
