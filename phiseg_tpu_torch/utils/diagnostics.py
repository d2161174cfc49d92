"""Per-level and per-layer training diagnostics for TensorBoard (port of
phiseg_tpu/utils/diagnostics.py:29-135).

The reference's three monitoring families:
  * per-level mu/sigma means of the posterior and the prior
    (phiseg/phiseg_model.py:719-726, average_[prior_]{mu,sigma}_lvl%d);
  * per-level output and accumulated-output label maps
    (:728-736, s_out, s_out_list_%d, s_accum_list_%d);
  * weight and activation histograms of every layer
    (tfwrapper/layers.py:671-677).

Histograms are reduced on the device (min, max, count, sum, sum of squares,
30 bucket counts) and only those numbers go to the host. Activations are
taken by forward hooks on the eval forward, where the JAX package uses
Flax's capture_intermediates.

Names follow the torch modules: a weight histogram is
"weights/<parameter name>" (e.g. weights/posterior.tower.level0_conv0.conv.weight
where the JAX package writes weights/posterior/level0_conv0/Conv_0/kernel),
an activation histogram "activations/<module name>", and first_conv_kernel
takes the first spatial kernel in registration order (posterior first; the
JAX package's traversal is alphabetical). The values are the same function
of the same tensor.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from phiseg_tpu_torch.engine.train import _eval_mode
from phiseg_tpu_torch.nn.losses import one_hot


def tensor_histogram(x: torch.Tensor, bins: int = 30) -> Dict[str, torch.Tensor]:
    """Histogram summary of one tensor, computed where it lives. Buckets as
    jnp.histogram's: equal widths from min to max (min +- 0.5 for a constant
    tensor), each closed on the left, the last closed on both sides."""
    v = x.detach().float().reshape(-1)
    lo, hi = v.min(), v.max()
    same = hi == lo
    e0, e1 = torch.where(same, lo - 0.5, lo), torch.where(same, lo + 0.5, hi)
    t = torch.arange(bins + 1, device=v.device, dtype=torch.float32) / bins
    edges = e0 * (1.0 - t) + e1 * t  # jnp.linspace's interpolation
    idx = torch.bucketize(v, edges, right=True)  # searchsorted side='right'
    idx = torch.where(v == edges[-1], bins, idx)
    counts = torch.bincount(idx, minlength=bins + 2)[1:bins + 1]
    return {
        "min": lo,
        "max": hi,
        "num": torch.tensor(float(v.numel()), device=v.device),
        "sum": v.sum(),
        "sum_squares": v.square().sum(),
        "bucket_limits": edges[1:],
        "bucket_counts": counts.float(),
    }


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree


def make_param_hist_fn(bins: int = 30):
    """fn(model) -> {"weights/<name>": histogram summary} of every floating
    parameter with at least 2 elements, as host numpy."""

    def param_hists(model: nn.Module):
        with torch.no_grad():
            return _to_host({f"weights/{name}": tensor_histogram(p, bins)
                             for name, p in model.named_parameters()
                             if p.is_floating_point() and p.numel() >= 2})

    return param_hists


def make_diag_fn(model, cfg, histograms: bool = True, bins: int = 30):
    """diag(x, s, generator=None, eps=None) -> (scalars, grids, hists), host numpy.

      scalars: average_[prior_]{mu,sigma}_lvl%d of each latent level;
      grids:   int32 label maps s_out, s_out_list_%d, s_accum_list_%d, the
               accumulation running from the coarsest level down (ref
               residual_multinoulli_loss's s_accum recursion :250-258);
      hists:   "activations/<module>" histogram summaries of every module's
               tensor output on the eval forward (empty without histograms).
    """

    def diag(x: torch.Tensor, s: torch.Tensor, generator: Optional[torch.Generator] = None,
             eps=None):
        hists: Dict[str, Dict[str, torch.Tensor]] = {}
        handles = []
        if histograms:
            def hook(name):
                def fn(module, inputs, out):
                    if isinstance(out, torch.Tensor) and out.is_floating_point() \
                            and out.numel() >= 2:
                        hists[f"activations/{name}"] = tensor_histogram(out, bins)
                return fn

            handles = [m.register_forward_hook(hook(name))
                       for name, m in model.named_modules() if name]
        try:
            with torch.no_grad(), _eval_mode(model):
                outputs = model(x, one_hot(s, cfg.nlabels), eps=eps, generator=generator)
        finally:
            for h in handles:
                h.remove()

        scalars = {}
        for i, (qm, qs, pm, ps) in enumerate(zip(outputs.q_mu, outputs.q_sigma,
                                                 outputs.p_mu, outputs.p_sigma)):
            scalars[f"average_mu_lvl{i}"] = qm.float().mean()
            scalars[f"average_sigma_lvl{i}"] = qs.float().mean()
            scalars[f"average_prior_mu_lvl{i}"] = pm.float().mean()
            scalars[f"average_prior_sigma_lvl{i}"] = ps.float().mean()

        s_list = outputs.s_out_list
        n = len(s_list)
        accum = [None] * n
        accum[n - 1] = s_list[n - 1]
        for i in range(n - 2, -1, -1):
            accum[i] = accum[i + 1] + s_list[i]
        grids = {"s_out": accum[0].argmax(-1).int()}
        for i in range(n):
            grids[f"s_out_list_{i}"] = s_list[i].argmax(-1).int()
            grids[f"s_accum_list_{i}"] = accum[i].argmax(-1).int()
        return _to_host(scalars), _to_host(grids), _to_host(hists)

    return diag


def first_conv_kernel(model: nn.Module) -> Tuple[str, Optional[np.ndarray]]:
    """The first spatial (kh, kw > 1) 4-D conv weight in registration order,
    else the first 4-D one, as a host HWIO array (the layout
    image_grid.kernels_to_grid takes; torch holds OIHW), for the kernel-grid
    image (ref put_kernels_on_grid, tfwrapper/utils.py:93-168)."""
    fallback: Tuple[str, Optional[np.ndarray]] = ("", None)
    for name, p in model.named_parameters():
        if p.ndim != 4:
            continue
        hwio = p.detach().cpu().permute(2, 3, 1, 0).numpy()
        if p.shape[2] > 1 and p.shape[3] > 1:
            return name, hwio
        if fallback[1] is None:
            fallback = (name, hwio)
    return fallback
