"""Segmentation-accuracy evaluation: per-label Dice over the test set
(port of phiseg_tpu/cli/test_predictions.py:28-113).

Equivalent of `phiseg_test_predictions.py` (ref :28-94): restore a tagged
checkpoint (`best_dice` by default), predict each test image as the argmax
of the MEAN softmax over N prior samples (N=100, or 1 for the deterministic
U-Net, ref :40), score per-label Dice against one annotator per image,
picked by np.random.RandomState(cfg.seed), with the both-empty -> 1 /
one-empty -> 0 convention (ref :72-78), and save

  dice_{tag}.npz   arr_0 (n, nlabels) Dice per image and label

in the log dir. The encoder runs once per image batch and the N draws
decode as one N x B batch; the noise comes from a generator seeded
cfg.seed + 101.

Usage:
  python -m phiseg_tpu_torch.cli.test_predictions <log_dir> [--samples 100]
      [--tag best_dice] [--batch 8] [--max-images N] [--synth-n-test N]
      [--device cuda|cpu]

`--device` defaults to cuda, and without a card that raises; `--device cpu`
evaluates on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

log = logging.getLogger(__name__)


def evaluate(log_dir: str, num_samples: int = 100, tag: str = "best_dice", batch: int = 8,
             max_images: int | None = None, synth_n_test: int | None = None,
             device: str = "cuda") -> np.ndarray:
    """Score `tag`'s checkpoint of log_dir over the test split; writes
    dice_{tag}.npz and returns its (n, nlabels) array."""
    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.loading import load_experiment
    from phiseg_tpu_torch.engine.train import make_sample_fn
    from phiseg_tpu_torch.metrics import dice_per_label

    cfg, model, _, step = load_experiment(log_dir, tag, device)
    device = next(model.parameters()).device
    log.info("restored %s @ step %d on %s", tag, step, device)
    if cfg.model_family == "det_unet":
        num_samples = 1  # deterministic net: one draw (ref :40)
    if synth_n_test is not None:
        cfg = cfg.replace(synth_n_test=synth_n_test)  # see test_quantitative
    data = get_dataset(cfg)
    sample = make_sample_fn(model, num_samples)

    images, labels = data.test.images, data.test.labels
    n = images.shape[0] if max_images is None else min(max_images, images.shape[0])
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 101)
    host_rng = np.random.RandomState(cfg.seed)
    dice_list = []
    t0 = time.time()
    for b0 in range(0, n, batch):
        b1 = min(b0 + batch, n)
        x = torch.from_numpy(np.asarray(images[b0:b1]).astype(np.float32)[..., None])
        ann = np.asarray(labels[b0:b1]).astype(np.int64)  # (B,H,W,M)
        # score against a random annotator (the reference scores against the
        # loader's random-annotator batch, :42-50)
        picks = host_rng.choice(list(cfg.annotator_range), size=b1 - b0)
        s_sel = np.stack([ann[i, :, :, a] for i, a in enumerate(picks)], 0)
        pred = sample(x.to(device), generator).mean(0).argmax(-1)
        d = dice_per_label(pred, torch.from_numpy(s_sel).to(device), cfg.nlabels)
        dice_list.append(d.cpu().numpy())
        log.info("%d/%d images (%.2f s/img)", b1, n, (time.time() - t0) / b1)

    dice_arr = np.concatenate(dice_list, 0)  # (n, nlabels)
    fg = dice_arr[:, 1:]
    log.info("-- mean foreground Dice: %.4f +- %.4f", fg.mean(), fg.std())
    np.savez(os.path.join(log_dir, f"dice_{tag}.npz"), dice_arr)
    return dice_arr


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("log_dir")
    p.add_argument("--samples", type=int, default=100)
    p.add_argument("--tag", default="best_dice")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--synth-n-test", type=int, default=None,
                   help="enlarge the synthetic test split for this eval")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to evaluate; cuda without a card raises")
    a = p.parse_args(argv)
    return evaluate(a.log_dir, a.samples, a.tag, a.batch, a.max_images,
                    synth_n_test=a.synth_n_test, device=a.device)


if __name__ == "__main__":
    main()
