"""Per-level sample construction figures (port of
phiseg_tpu/cli/sample_construction.py).

Equivalent of `phiseg_sample_construction.py` (ref :23-137): for selected
test images, draw one prior sample and show each latent level's residual
logit contribution and the accumulated segmentation from the coarsest level
down: how the hierarchy composes a sample.

`construction_arrays` computes, on the model's device (the card by
default), per level coarsest first: the residual's foreground-background
logit difference, the argmax of the logits accumulated so far and their
softmax's last class (JAX sample_construction.py:54-66). `render` draws the
figure with matplotlib, imported only there: without matplotlib the CLI
raises ImportError before it loads the model, as the JAX CLI does. The
figures are construction_img{idx}_{tag}.png in <log_dir>/sample_construction
(or --out-dir).

Usage:
  python -m phiseg_tpu_torch.cli.sample_construction <log_dir> [--indices 0 1]
      [--tag best_ged] [--out-dir DIR] [--device cuda|cpu]

`--device` defaults to cuda, and without a card that raises.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from phiseg_tpu_torch.cli.generate_samples import image_generator

log = logging.getLogger(__name__)


def construction_arrays(levels_fn, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                        eps: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """One draw's construction of x (1,H,W,Cin), levels_fn a
    make_sample_levels_fn of one draw. Returns, each (L,H,W) and ordered
    coarsest level first: "residual" (last minus first class of the level's
    logits), "mask" (argmax of the logits summed down to that level) and
    "softmax_fg" (their softmax's last class); and "level", the level
    index of each row."""
    levels = [t[0, 0] for t in levels_fn(x, generator, eps)]  # L x (H,W,C)
    order = list(reversed(range(len(levels))))
    accum = torch.zeros_like(levels[0])
    residual, mask, softmax_fg = [], [], []
    for lvl in order:
        resid = levels[lvl]
        accum = accum + resid
        residual.append(resid[..., -1] - resid[..., 0])
        mask.append(accum.argmax(-1))
        softmax_fg.append(torch.softmax(accum, dim=-1)[..., -1])
    return {"residual": torch.stack(residual), "mask": torch.stack(mask),
            "softmax_fg": torch.stack(softmax_fg), "level": torch.tensor(order)}


def render(path: str, x: np.ndarray, arrays: Dict[str, np.ndarray], nlabels: int) -> None:
    """The figure of one image (JAX sample_construction.py:47-71)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(arrays["level"])
    fig, axes = plt.subplots(3, n + 1, figsize=(1.6 * (n + 1), 5))
    for ax in axes.ravel():
        ax.axis("off")
    axes[0, 0].imshow(x[..., 0], cmap="gray")
    axes[0, 0].set_title("input", fontsize=7)
    for col, lvl in enumerate(arrays["level"]):
        axes[0, col + 1].imshow(arrays["residual"][col], cmap="coolwarm")
        axes[0, col + 1].set_title(f"residual lvl {lvl}", fontsize=7)
        axes[1, col + 1].imshow(arrays["mask"][col], vmin=0, vmax=nlabels - 1)
        axes[1, col + 1].set_title(f"accum seg >= lvl {lvl}", fontsize=7)
        axes[2, col + 1].imshow(arrays["softmax_fg"][col], cmap="viridis", vmin=0, vmax=1)
        axes[2, col + 1].set_title("accum softmax fg", fontsize=7)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)


def generate(log_dir: str, tag: str = "best_ged", indices=None, out_dir: Optional[str] = None,
             device: str = "cuda") -> str:
    """Write construction_img{idx}_{tag}.png for each index; returns the directory."""
    import matplotlib  # noqa: F401 -- the render needs it: fail before the work

    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.loading import load_experiment
    from phiseg_tpu_torch.engine.train import make_sample_levels_fn

    cfg, model, _, _ = load_experiment(log_dir, tag, device)
    device = next(model.parameters()).device
    data = get_dataset(cfg)
    levels_fn = make_sample_levels_fn(model, 1)
    out_dir = out_dir or os.path.join(log_dir, "sample_construction")
    os.makedirs(out_dir, exist_ok=True)
    indices = indices or list(range(min(2, data.test.images.shape[0])))
    for idx in indices:
        x = np.asarray(data.test.images[idx]).astype(np.float32)[..., None]  # (H,W,1)
        arrays = construction_arrays(levels_fn, torch.from_numpy(x[None]).to(device),
                                     image_generator(device, cfg.seed + 13, idx))
        path = os.path.join(out_dir, f"construction_img{idx}_{tag}.png")
        render(path, x, {k: v.cpu().numpy() for k, v in arrays.items()}, cfg.nlabels)
        log.info("wrote %s", path)
    return out_dir


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("log_dir")
    p.add_argument("--tag", default="best_ged")
    p.add_argument("--indices", type=int, nargs="*", default=None)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to sample; cuda without a card raises")
    a = p.parse_args(argv)
    return generate(a.log_dir, a.tag, a.indices, a.out_dir, a.device)


if __name__ == "__main__":
    main()
