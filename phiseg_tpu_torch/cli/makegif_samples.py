"""Animated GIF of prior segmentation samples (port of
phiseg_tpu/cli/makegif_samples.py).

Equivalent of `phiseg_makegif_samples.py` (ref :52-163): draw N prior samples
for selected test images and write an animated GIF cycling through them, the
segmentation's contour drawn over the input.

The samples are drawn on the model's device (the card by default); the
frames are numpy arrays (`frames`), each the input in grey with the contour
of one sample's foreground in red, enlarged 4x by pixel repetition (the JAX
CLI's PIL nearest resize). PIL is imported only to write the GIF: without it
the CLI raises ImportError before it loads the model, as the JAX CLI does.
The GIFs are samples_img{idx}_{tag}.gif in <log_dir>/gifs (or --out-dir).

Usage:
  python -m phiseg_tpu_torch.cli.makegif_samples <log_dir> [--samples 20]
      [--indices 0] [--tag best_ged] [--out-dir DIR] [--device cuda|cpu]

`--device` defaults to cuda, and without a card that raises.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional

import numpy as np

from phiseg_tpu_torch.cli.generate_samples import image_generator

log = logging.getLogger(__name__)

SCALE = 4  # frame pixels per image pixel


def _to_uint8(img: np.ndarray) -> np.ndarray:
    img = img - img.min()
    img = img / max(img.max(), 1e-12)
    return (img * 255).astype(np.uint8)


def _contour(mask: np.ndarray) -> np.ndarray:
    """Binary contour via erosion difference (no cv2 needed)."""
    m = mask.astype(bool)
    er = m.copy()
    er[1:, :] &= m[:-1, :]
    er[:-1, :] &= m[1:, :]
    er[:, 1:] &= m[:, :-1]
    er[:, :-1] &= m[:, 1:]
    return m & ~er


def frames(x: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """(S, SCALE*H, SCALE*W, 3) uint8 frames of the image x (H,W) and the
    sample masks (S,H,W)."""
    base = _to_uint8(x)
    out = np.empty((masks.shape[0], *x.shape, 3), np.uint8)
    for s in range(masks.shape[0]):
        frame = np.stack([base, base, base], -1)
        frame[_contour(masks[s] > 0)] = [255, 64, 64]
        out[s] = frame
    return out.repeat(SCALE, axis=1).repeat(SCALE, axis=2)


def write_gif(path: str, frame_arrays: np.ndarray, fps: int = 4) -> None:
    from PIL import Image

    images = [Image.fromarray(f) for f in frame_arrays]
    images[0].save(path, save_all=True, append_images=images[1:], duration=int(1000 / fps),
                   loop=0)


def generate(log_dir: str, num_samples: int = 20, tag: str = "best_ged", indices=None,
             out_dir: Optional[str] = None, fps: int = 4, device: str = "cuda") -> str:
    """Write samples_img{idx}_{tag}.gif for each index; returns the directory."""
    import PIL  # noqa: F401 -- the GIF needs it: fail before the work
    import torch

    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.loading import load_experiment
    from phiseg_tpu_torch.engine.train import make_sample_fn

    cfg, model, _, _ = load_experiment(log_dir, tag, device)
    device = next(model.parameters()).device
    data = get_dataset(cfg)
    sample_fn = make_sample_fn(model, num_samples)
    out_dir = out_dir or os.path.join(log_dir, "gifs")
    os.makedirs(out_dir, exist_ok=True)
    indices = indices or list(range(min(2, data.test.images.shape[0])))
    for idx in indices:
        x = np.asarray(data.test.images[idx]).astype(np.float32)
        probs = sample_fn(torch.from_numpy(x[None, ..., None]).to(device),
                          image_generator(device, cfg.seed + 23, idx))[:, 0]
        path = os.path.join(out_dir, f"samples_img{idx}_{tag}.gif")
        write_gif(path, frames(x, probs.argmax(-1).cpu().numpy()), fps)
        log.info("wrote %s", path)
    return out_dir


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("log_dir")
    p.add_argument("--samples", type=int, default=20)
    p.add_argument("--tag", default="best_ged")
    p.add_argument("--indices", type=int, nargs="*", default=None)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to sample; cuda without a card raises")
    a = p.parse_args(argv)
    return generate(a.log_dir, a.samples, a.tag, a.indices, a.out_dir, device=a.device)


if __name__ == "__main__":
    main()
