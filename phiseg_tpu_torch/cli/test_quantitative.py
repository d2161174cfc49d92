"""Quantitative uncertainty evaluation: GED^2 and S_NCC over the test set
(port of phiseg_tpu/cli/test_quantitative.py:32-136).

Equivalent of `phiseg_test_quantitative.py` (ref :22-81): restore a tagged
checkpoint (`best_ged` by default), draw N prior samples per test image,
compute GED^2 against all annotators and S_NCC, and save the per-image
arrays in the log dir with the JAX package's file contract:

  ged{N}_{tag}{suffix}.npz   arr_0 (n,) GED^2, and d_sy, d_ss, d_yy (n,),
                             n_samples, n_annotators
  ncc{N}_{tag}{suffix}.npz   arr_0 (n,) S_NCC

which `phiseg_tpu.cli.eval_plots` reads. The encoder runs once per image
batch and the N draws decode as one N x B batch.

Usage:
  python -m phiseg_tpu_torch.cli.test_quantitative <log_dir> [--samples 50]
      [--tag best_ged] [--batch 8] [--max-images N] [--synth-n-test N]
      [--out-suffix _48k] [--device cuda|cpu]

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


def evaluate(log_dir: str, num_samples: int = 50, tag: str = "best_ged", batch: int = 8,
             max_images: int | None = None, synth_n_test: int | None = None,
             out_suffix: str = "", device: str = "cuda"):
    """Score `tag`'s checkpoint of log_dir over the test split; writes the
    two npz files and returns (ged (n,), ncc (n,))."""
    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.loading import load_experiment
    from phiseg_tpu_torch.engine.validation import make_quant_eval_fn

    cfg, model, _, step = load_experiment(log_dir, tag, device)
    device = next(model.parameters()).device
    log.info("restored %s @ step %d on %s", tag, step, device)
    if synth_n_test is not None:
        # enlarge the synthetic test split (same seed: the first images are
        # unchanged), e.g. to evaluate at the reference's scale
        cfg = cfg.replace(synth_n_test=synth_n_test)
    data = get_dataset(cfg)
    quant = make_quant_eval_fn(model, cfg, num_samples)

    images, labels = data.test.images, data.test.labels
    n = images.shape[0] if max_images is None else min(max_images, images.shape[0])
    generator = torch.Generator(device=device).manual_seed(cfg.seed + 99)
    ged_list, ncc_list, term_list = [], [], []
    t0 = time.time()
    for b0 in range(0, n, batch):
        b1 = min(b0 + batch, n)
        x = torch.from_numpy(np.asarray(images[b0:b1]).astype(np.float32)[..., None])
        ann = np.transpose(np.asarray(labels[b0:b1]).astype(np.int32), (0, 3, 1, 2))
        g, nc, terms = quant(x.to(device), torch.from_numpy(ann).to(device), generator)
        ged_list.append(g.cpu().numpy())
        ncc_list.append(nc.cpu().numpy())
        term_list.append(terms.cpu().numpy())
        log.info("%d/%d images (%.2f s/img)", b1, n, (time.time() - t0) / b1)

    ged_arr = np.concatenate(ged_list)
    ncc_arr = np.concatenate(ncc_list)
    term_arr = np.concatenate(term_list, axis=0)  # (n, 3): d_sy, d_ss, d_yy
    log.info("-- GED: %.4f +- %.4f", ged_arr.mean(), ged_arr.std())
    log.info("-- NCC: %.4f +- %.4f", ncc_arr.mean(), ncc_arr.std())
    log.info("-- GED terms: fit d_sy %.4f | sample diversity d_ss %.4f | "
             "annotator diversity d_yy %.4f (ss/yy %.3f)", term_arr[:, 0].mean(),
             term_arr[:, 1].mean(), term_arr[:, 2].mean(),
             term_arr[:, 1].mean() / max(term_arr[:, 2].mean(), 1e-12))

    # The reference's artefact names (:80-81): the positional array stays
    # arr_0, the GED terms and the sample / annotator counts ride along
    # (n_samples and n_annotators give the estimator's finite-N/M floor).
    n_annotators = int(np.asarray(labels).shape[-1])
    np.savez(os.path.join(log_dir, f"ged{num_samples}_{tag}{out_suffix}.npz"), ged_arr,
             d_sy=term_arr[:, 0], d_ss=term_arr[:, 1], d_yy=term_arr[:, 2],
             n_samples=np.asarray(num_samples), n_annotators=np.asarray(n_annotators))
    np.savez(os.path.join(log_dir, f"ncc{num_samples}_{tag}{out_suffix}.npz"), ncc_arr)
    return ged_arr, ncc_arr


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("log_dir")
    p.add_argument("--samples", type=int, default=50)
    p.add_argument("--tag", default="best_ged")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--synth-n-test", type=int, default=None,
                   help="enlarge the synthetic test split for this eval")
    p.add_argument("--out-suffix", default="",
                   help="append to the npz stem (don't overwrite canonical files)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to evaluate; cuda without a card raises")
    a = p.parse_args(argv)
    return evaluate(a.log_dir, a.samples, a.tag, a.batch, a.max_images,
                    synth_n_test=a.synth_n_test, out_suffix=a.out_suffix, device=a.device)


if __name__ == "__main__":
    main()
