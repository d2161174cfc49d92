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
      [--device cuda|cpu] [--mesh N]

`--device` defaults to cuda, and without a card that raises; `--device cpu`
evaluates on the CPU. `--mesh N` splits the draws over N local ranks as
test_quantitative's does (rank 0 writes; the result is `--mesh 1`'s up to
the compute dtype's round-off); with one draw (the deterministic U-Net) every rank decodes it whole, as JAX's
`--mesh` is ignored there (:45).
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
             device: str = "cuda", mesh=None) -> np.ndarray:
    """Score `tag`'s checkpoint of log_dir over the test split; writes
    dice_{tag}.npz and returns its (n, nlabels) array. With a mesh the
    draws are split over its ranks, on the mesh's device, and only rank 0
    writes."""
    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.loading import load_experiment
    from phiseg_tpu_torch.engine.train import make_sample_fn
    from phiseg_tpu_torch.metrics import dice_per_label

    cfg, model, _, step = load_experiment(log_dir, tag, device if mesh is None else mesh.device)
    device = next(model.parameters()).device
    log.info("restored %s @ step %d on %s", tag, step, device)
    if cfg.model_family == "det_unet":
        num_samples = 1  # deterministic net: one draw (ref :40)
    if synth_n_test is not None:
        cfg = cfg.replace(synth_n_test=synth_n_test)  # see test_quantitative
    data = get_dataset(cfg)
    sample = make_sample_fn(model, num_samples, mesh=mesh if num_samples > 1 else None)

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
    if mesh is not None and mesh.rank:
        return dice_arr
    np.savez(os.path.join(log_dir, f"dice_{tag}.npz"), dice_arr)
    return dice_arr


def _evaluate_rank(kwargs: dict, world_size: int):
    """One rank of `--mesh N` (runs in a process of its own)."""
    from phiseg_tpu_torch.parallel import make_mesh

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    return evaluate(**kwargs, mesh=make_mesh(world_size, device=kwargs["device"]))


def main(argv=None, timeout=None):
    """Run the evaluation; returns the (n, nlabels) Dice, rank 0's with
    `--mesh` (`timeout` bounds the ranks' run, in seconds)."""
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
    p.add_argument("--mesh", type=int, default=None,
                   help="number of local ranks that split the draws")
    a = p.parse_args(argv)
    kwargs = dict(log_dir=a.log_dir, num_samples=a.samples, tag=a.tag, batch=a.batch,
                  max_images=a.max_images, synth_n_test=a.synth_n_test, device=a.device)
    if a.mesh:
        from phiseg_tpu_torch import parallel

        parallel.resolve_device(a.device)  # cuda without a card raises here
        backend = parallel.local_backend(a.device, a.mesh)
        return parallel.spawn_ranks(_evaluate_rank, a.mesh, (kwargs, a.mesh), backend=backend,
                                    timeout=timeout)[0]
    return evaluate(**kwargs)


if __name__ == "__main__":
    main()
