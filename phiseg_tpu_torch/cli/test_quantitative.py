"""Quantitative uncertainty evaluation: GED^2 and S_NCC over the test set
(port of phiseg_tpu/cli/test_quantitative.py:32-136).

Equivalent of `phiseg_test_quantitative.py` (ref :22-81): restore a tagged
checkpoint (`best_ged` by default), draw N prior samples per test image,
compute GED^2 against all annotators and S_NCC, and save the per-image
arrays in the log dir with the JAX package's file contract:

  ged{N}_{tag}{suffix}.npz   arr_0 (n,) GED^2, and d_sy, d_ss, d_yy (n,),
                             n_samples, n_annotators
  ncc{N}_{tag}{suffix}.npz   arr_0 (n,) S_NCC

which `phiseg_tpu_torch.cli.eval_plots` reads. The encoder runs once per
image batch and the N draws decode as one N x B batch.

Usage:
  python -m phiseg_tpu_torch.cli.test_quantitative <log_dir> [--samples 50]
      [--tag best_ged] [--batch 8] [--max-images N] [--synth-n-test N]
      [--out-suffix _48k] [--device cuda|cpu] [--mesh N]

`--device` defaults to cuda, and without a card that raises; `--device cpu`
evaluates on the CPU. `--mesh N` starts N local ranks (JAX's `--mesh`
shards over the local devices): each decodes N-th of the draws of every
batch from the same noise, every rank computes the metrics on all of them,
and rank 0 writes the files. The result is `--mesh 1`'s up to the compute
dtype's round-off: a rank decodes fewer rows, and cuDNN picks its algorithm
by shape (in bf16 on an H100, S_NCC moves by ~2.5e-4 relative). The backend
is NCCL on cuda (one rank per card) and gloo on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

log = logging.getLogger(__name__)


def score_test_split(log_dir: str, num_samples: int = 50, tag: str = "best_ged",
                     batch: int = 8, max_images: int | None = None,
                     synth_n_test: int | None = None, device: str = "cuda", mesh=None):
    """Draw `num_samples` prior samples per test image from `tag`'s
    checkpoint of log_dir and score them. Returns (step, n_annotators, ged
    (n,), ncc (n,), terms (n, 3) of d_sy, d_ss, d_yy). The noise comes from
    one generator seeded cfg.seed + 99, consumed batch by batch; the last
    batch is simply shorter. With a mesh (parallel.mesh.Mesh) the draws
    are split over its ranks, on the mesh's device."""
    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.loading import load_experiment
    from phiseg_tpu_torch.engine.validation import make_quant_eval_fn

    cfg, model, _, step = load_experiment(log_dir, tag, device if mesh is None else mesh.device)
    device = next(model.parameters()).device
    log.info("restored %s @ step %d on %s", tag, step, device)
    if synth_n_test is not None:
        # enlarge the synthetic test split (same seed: the first images are
        # unchanged), e.g. to evaluate at the reference's scale
        cfg = cfg.replace(synth_n_test=synth_n_test)
    data = get_dataset(cfg)
    quant = make_quant_eval_fn(model, cfg, num_samples, mesh=mesh)

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
    n_annotators = int(np.asarray(labels).shape[-1])
    return (step, n_annotators, np.concatenate(ged_list), np.concatenate(ncc_list),
            np.concatenate(term_list, axis=0))


def evaluate(log_dir: str, num_samples: int = 50, tag: str = "best_ged", batch: int = 8,
             max_images: int | None = None, synth_n_test: int | None = None,
             out_suffix: str = "", device: str = "cuda", mesh=None):
    """Score `tag`'s checkpoint of log_dir over the test split; writes the
    two npz files and returns (ged (n,), ncc (n,)). With a mesh
    (parallel.mesh.Mesh) the draws are split over its ranks, on the mesh's
    device, and only rank 0 writes."""
    _, n_annotators, ged_arr, ncc_arr, term_arr = score_test_split(
        log_dir, num_samples, tag, batch, max_images, synth_n_test, device, mesh)
    log.info("-- GED: %.4f +- %.4f", ged_arr.mean(), ged_arr.std())
    log.info("-- NCC: %.4f +- %.4f", ncc_arr.mean(), ncc_arr.std())
    log.info("-- GED terms: fit d_sy %.4f | sample diversity d_ss %.4f | "
             "annotator diversity d_yy %.4f (ss/yy %.3f)", term_arr[:, 0].mean(),
             term_arr[:, 1].mean(), term_arr[:, 2].mean(),
             term_arr[:, 1].mean() / max(term_arr[:, 2].mean(), 1e-12))

    if mesh is not None and mesh.rank:
        return ged_arr, ncc_arr
    # The reference's artefact names (:80-81): the positional array stays
    # arr_0, the GED terms and the sample / annotator counts ride along
    # (n_samples and n_annotators give the estimator's finite-N/M floor).
    np.savez(os.path.join(log_dir, f"ged{num_samples}_{tag}{out_suffix}.npz"), ged_arr,
             d_sy=term_arr[:, 0], d_ss=term_arr[:, 1], d_yy=term_arr[:, 2],
             n_samples=np.asarray(num_samples), n_annotators=np.asarray(n_annotators))
    np.savez(os.path.join(log_dir, f"ncc{num_samples}_{tag}{out_suffix}.npz"), ncc_arr)
    return ged_arr, ncc_arr


def _evaluate_rank(kwargs: dict, world_size: int):
    """One rank of `--mesh N` (runs in a process of its own)."""
    from phiseg_tpu_torch.parallel import make_mesh

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    return evaluate(**kwargs, mesh=make_mesh(world_size, device=kwargs["device"]))


def main(argv=None, timeout=None):
    """Run the evaluation; returns (ged (n,), ncc (n,)), rank 0's with
    `--mesh` (`timeout` bounds the ranks' run, in seconds)."""
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
    p.add_argument("--mesh", type=int, default=None,
                   help="number of local ranks that split the draws")
    a = p.parse_args(argv)
    kwargs = dict(log_dir=a.log_dir, num_samples=a.samples, tag=a.tag, batch=a.batch,
                  max_images=a.max_images, synth_n_test=a.synth_n_test,
                  out_suffix=a.out_suffix, device=a.device)
    if a.mesh:
        from phiseg_tpu_torch import parallel

        parallel.resolve_device(a.device)  # cuda without a card raises here
        backend = parallel.local_backend(a.device, a.mesh)
        return parallel.spawn_ranks(_evaluate_rank, a.mesh, (kwargs, a.mesh), backend=backend,
                                    timeout=timeout)[0]
    return evaluate(**kwargs)


if __name__ == "__main__":
    main()
