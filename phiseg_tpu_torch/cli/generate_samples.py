"""Qualitative sample generation: sample grids and uncertainty error maps
(port of phiseg_tpu/cli/generate_samples.py).

Equivalent of `phiseg_generate_samples.py` (ref :46-187): for selected test
images draw N prior samples and save a figure with the input, all GT
annotations, 16 sample segmentations and the three error maps
  E_ss -- expected xent of samples vs. their mean (model uncertainty)
  E_sy -- expected xent of samples vs. the GTs    (model-vs-raters)
  E_yy -- expected xent of GTs vs. their mean     (inter-rater)
(ref generate_error_maps :46-83).

The work is split in two: `compute_sample_maps` draws the samples and
computes the masks and the error maps on the model's device (the card by
default), and `render` draws the figure with matplotlib, imported only
there: without matplotlib the CLI raises ImportError before it loads the
model, as the JAX CLI does. The figures are samples_img{idx}_{tag}.png in
<log_dir>/samples (or --out-dir).

Usage:
  python -m phiseg_tpu_torch.cli.generate_samples <log_dir> [--samples 100]
      [--indices 10 20 30] [--tag best_ged] [--out-dir DIR] [--device cuda|cpu]

`--device` defaults to cuda, and without a card that raises.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

log = logging.getLogger(__name__)


def error_maps(sample_probs: torch.Tensor, gt_oh: torch.Tensor, eps: float = 1e-8):
    """E_ss, E_sy, E_yy (H, W) maps of sample_probs (S,H,W,C) and the
    annotators' one-hot gt_oh (M,H,W,C) (ref phiseg_generate_samples.py:46-83)."""
    gt_oh = gt_oh.to(sample_probs.dtype)
    n_s, n_m = sample_probs.shape[0], gt_oh.shape[0]
    mean_s = sample_probs.mean(0)
    log_s = torch.log(sample_probs + eps)
    e_ss = -torch.einsum("hwc,nhwc->hw", mean_s, log_s) / n_s
    e_sy = -torch.einsum("mhwc,nhwc->hw", gt_oh, log_s) / (n_s * n_m)
    mean_y = gt_oh.mean(0)
    e_yy = -torch.einsum("hwc,mhwc->hw", mean_y, torch.log(gt_oh + eps)) / n_m
    return e_ss, e_sy, e_yy


def image_generator(device, seed: int, idx: int) -> torch.Generator:
    """The noise of test image `idx` for a CLI whose base seed is `seed`."""
    return torch.Generator(device=device).manual_seed((seed << 20) + idx)


def compute_sample_maps(sample_fn, x: torch.Tensor, gts: torch.Tensor, nlabels: int,
                        generator: Optional[torch.Generator] = None,
                        eps: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """One image's figure data on its device: x (1,H,W,Cin), gts (H,W,M)
    integer annotations, sample_fn a make_sample_fn of S draws. Returns the
    probabilities (S,H,W,C), masks (S,H,W) and the three error maps (H,W)."""
    probs = sample_fn(x, generator, eps)[:, 0]
    gt_oh = torch.nn.functional.one_hot(gts.long().permute(2, 0, 1), nlabels).to(probs.dtype)
    e_ss, e_sy, e_yy = error_maps(probs, gt_oh)
    return {"probs": probs, "masks": probs.argmax(-1), "e_ss": e_ss, "e_sy": e_sy, "e_yy": e_yy}


def render(path: str, x: np.ndarray, gts: np.ndarray, maps: Dict[str, np.ndarray],
           nlabels: int) -> None:
    """The figure of one image (JAX generate_samples.py:72-96): input and
    GTs, up to 16 sample masks, the three error maps."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    masks = maps["masks"]
    n_show = min(16, masks.shape[0])
    m = gts.shape[-1]
    cols = max(n_show, m + 1, 3)  # >= 3 for the error-map row
    fig, axes = plt.subplots(3, cols, figsize=(1.2 * cols, 4))
    for ax in axes.ravel():
        ax.axis("off")
    axes[0, 0].imshow(x[..., 0], cmap="gray")
    axes[0, 0].set_title("input", fontsize=6)
    for j in range(m):
        axes[0, j + 1].imshow(gts[..., j], vmin=0, vmax=nlabels - 1)
        axes[0, j + 1].set_title(f"GT {j}", fontsize=6)
    for j in range(n_show):
        axes[1, j].imshow(masks[j], vmin=0, vmax=nlabels - 1)
    for j, name in enumerate(("E_ss", "E_sy", "E_yy")):
        axes[2, j].imshow(maps[name.lower()], cmap="magma")
        axes[2, j].set_title(name, fontsize=6)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def generate(log_dir: str, num_samples: int = 100, tag: str = "best_ged", indices=None,
             out_dir: Optional[str] = None, device: str = "cuda") -> str:
    """Write samples_img{idx}_{tag}.png for each index; returns the directory."""
    import matplotlib  # noqa: F401 -- the render needs it: fail before the work

    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.loading import load_experiment
    from phiseg_tpu_torch.engine.train import make_sample_fn

    cfg, model, _, _ = load_experiment(log_dir, tag, device)
    device = next(model.parameters()).device
    data = get_dataset(cfg)
    sample_fn = make_sample_fn(model, num_samples)
    out_dir = out_dir or os.path.join(log_dir, "samples")
    os.makedirs(out_dir, exist_ok=True)
    indices = indices or list(range(min(4, data.test.images.shape[0])))
    for idx in indices:
        x = np.asarray(data.test.images[idx]).astype(np.float32)[..., None]  # (H,W,1)
        gts = np.asarray(data.test.labels[idx]).astype(np.int64)            # (H,W,M)
        maps = compute_sample_maps(sample_fn, torch.from_numpy(x[None]).to(device),
                                   torch.from_numpy(gts).to(device), cfg.nlabels,
                                   image_generator(device, cfg.seed + 7, idx))
        path = os.path.join(out_dir, f"samples_img{idx}_{tag}.png")
        render(path, x, gts, {k: v.cpu().numpy() for k, v in maps.items()}, cfg.nlabels)
        log.info("wrote %s", path)
    return out_dir


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("log_dir")
    p.add_argument("--samples", type=int, default=100)
    p.add_argument("--tag", default="best_ged")
    p.add_argument("--indices", type=int, nargs="*", default=None)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to sample; cuda without a card raises")
    a = p.parse_args(argv)
    return generate(a.log_dir, a.samples, a.tag, a.indices, a.out_dir, a.device)


if __name__ == "__main__":
    main()
