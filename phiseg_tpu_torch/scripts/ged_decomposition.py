"""GED^2 term decomposition across trained families: WHY a model wins/loses
(port of scripts/ged_decomposition.py: the same arguments and table).

GED^2 = 2*d_sy - d_ss - d_yy  (reference estimator, utils.py:294-322). The
combined number hides the mechanism: a model can lose GED by fitting worse
(high d_sy), by sampling too little diversity (d_ss << d_yy), or too much
(d_ss >> d_yy). Perfectly calibrated uncertainty has d_ss == d_yy == d_sy.

For each given log dir (the port's `.pt` checkpoints or phiseg_tpu's
`.msgpack` ones) this restores the `best_ged` checkpoint, draws N prior
samples per test image and prints the per-image-mean terms plus the
diversity calibration ratio d_ss/d_yy. The draws are
`phiseg_tpu_torch.cli.test_quantitative`'s own (`score_test_split`: one
generator seeded cfg.seed + 99, consumed batch by batch), so at the same
--samples and --batch the terms are the ones it writes into
ged{N}_best_ged.npz. This tool is for checkpoints whose npz predate the
terms, or for ad-hoc sample counts without rewriting artifacts.

Usage:
  python -m phiseg_tpu_torch ged_decomposition LOGDIR [LOGDIR ...] \
      [--samples 50] [--batch 8] [--synth-n-test N] [--max-images N] \
      [--json OUT.json] [--device cuda|cpu]

`--device` defaults to cuda, and without a card that raises.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

log = logging.getLogger(__name__)


def decompose(log_dir: str, num_samples: int, batch: int,
              synth_n_test: int | None, max_images: int | None, device: str = "cuda"):
    """The per-image-mean terms of best_ged's test split, with its step and
    GED^2; terms (n, 3) of d_sy, d_ss, d_yy come from score_test_split."""
    from phiseg_tpu_torch.cli.test_quantitative import score_test_split

    t0 = time.time()
    step, _, _, _, terms = score_test_split(log_dir, num_samples, "best_ged", batch,
                                            max_images, synth_n_test, device)
    n = terms.shape[0]
    d_sy, d_ss, d_yy = terms.mean(axis=0)
    ged = float((2 * terms[:, 0] - terms[:, 1] - terms[:, 2]).mean())
    log.info("%s: %d imgs in %.1fs", log_dir, n, time.time() - t0)
    return {
        "log_dir": log_dir,
        "step": int(step),
        "n_images": int(n),
        "samples": num_samples,
        "ged2": ged,
        "d_sy_fit": float(d_sy),
        "d_ss_sample_diversity": float(d_ss),
        "d_yy_annotator_diversity": float(d_yy),
        "diversity_ratio_ss_over_yy": float(d_ss / d_yy) if d_yy else None,
    }


def main(argv=None):
    """Print the table; returns the list of per-dir result dicts."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("log_dirs", nargs="+")
    p.add_argument("--samples", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--synth-n-test", type=int, default=None)
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--json", default=None, help="also dump results to this file")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to sample; cuda without a card raises")
    a = p.parse_args(argv)

    results = [
        decompose(d, a.samples, a.batch, a.synth_n_test, a.max_images, a.device)
        for d in a.log_dirs
    ]
    hdr = (f"{'experiment':34s} {'GED^2':>7s} {'d_sy':>7s} {'d_ss':>7s} "
           f"{'d_yy':>7s} {'ss/yy':>6s}")
    print(hdr)
    for r in results:
        name = r["log_dir"].rstrip("/").split("/")[-1]
        print(f"{name:34s} {r['ged2']:7.4f} {r['d_sy_fit']:7.4f} "
              f"{r['d_ss_sample_diversity']:7.4f} "
              f"{r['d_yy_annotator_diversity']:7.4f} "
              f"{r['diversity_ratio_ss_over_yy']:6.3f}")
    if a.json:
        with open(a.json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
