"""Paired significance tests + GED term decomposition for two eval dirs
(port of scripts/pair_stats.py, whose printed text it gives byte for byte).

Given two experiment dirs (each holding ged{N}_{tag}{suffix}.npz /
ncc{N}_{tag}{suffix}.npz from `phiseg_tpu_torch.cli.test_quantitative` or
the JAX package's CLI), print paired t-tests over the common test images
for biased GED^2 (the reference estimator, utils.py:294-322), unbiased
GED^2 (self-pair-corrected from the embedded term decomposition), and
S_NCC, plus each model's fit/diversity terms and population-corrected
diversity ratio d_ss/(d_yy*M/(M-1)) (1.0 = calibrated sampler).

Usage:
  python -m phiseg_tpu_torch pair_stats results/lidc_bfxl/phiseg_7_5_bfxl \
      results/lidc_bfxl/probunet_bfxl [--suffix _48k] [--samples 50]
Pure numpy and scipy: no device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from scipy import stats

from phiseg_tpu_torch.metrics import estimator


def load(d: str, samples: int, tag: str, suffix: str):
    out = {}
    f = os.path.join(d, f"ged{samples}_{tag}{suffix}.npz")
    with np.load(f) as z:
        out["ged"] = np.asarray(z["arr_0"])
        for k in ("d_sy", "d_ss", "d_yy"):
            out[k] = np.asarray(z[k])
        out["N"], out["M"] = int(z["n_samples"]), int(z["n_annotators"])
    # NaN (printed as n/a, t-test skipped) when N=1 or M=1: the correction
    # is undefined there
    out["ged_ub"] = estimator.unbiased_ged(
        out["d_sy"], out["d_ss"], out["d_yy"], out["N"], out["M"])
    f = os.path.join(d, f"ncc{samples}_{tag}{suffix}.npz")
    if os.path.exists(f):
        with np.load(f) as z:
            out["ncc"] = np.asarray(z["arr_0"])
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dir_a")
    p.add_argument("dir_b")
    p.add_argument("--samples", type=int, default=50)
    p.add_argument("--tag", default="best_ged")
    p.add_argument("--suffix", default="")
    a = p.parse_args(argv)

    A = load(a.dir_a, a.samples, a.tag, a.suffix)
    B = load(a.dir_b, a.samples, a.tag, a.suffix)
    na, nb = os.path.basename(a.dir_a.rstrip("/")), os.path.basename(a.dir_b.rstrip("/"))
    n = len(A["ged"])
    if n != len(B["ged"]):
        raise ValueError("pair requires the same test split")
    # The annotator-only term depends solely on the GT split and its
    # ordering, so two dirs evaluated on different splits of the same size
    # would otherwise give a bogus paired p-value.
    if not np.allclose(A["d_yy"], B["d_yy"]):
        raise ValueError("d_yy differs between the two dirs -- these evals are not over the "
                         "same test split/ordering, so a paired t-test is invalid")

    print(f"paired over n={n} test images ({na} vs {nb}, "
          f"N={A['N']} samples, M={A['M']} annotators, suffix='{a.suffix}')")
    for key, label, arrow in [("ged", "biased GED^2", "lower"),
                              ("ged_ub", "unbiased GED^2", "lower"),
                              ("ncc", "S_NCC", "higher")]:
        if key not in A or key not in B:
            continue
        if np.isnan(A[key]).any() or np.isnan(B[key]).any():
            print(f"  {label:15s}: n/a (correction undefined at "
                  f"N={A['N']}, M={A['M']} -- need N>1 and M>1)")
            continue
        t, pv = stats.ttest_rel(A[key], B[key])
        d = float(np.mean(A[key] - B[key]))
        better = na if (d < 0) == (arrow == "lower") else nb
        print(f"  {label:15s}: {A[key].mean():.4f} vs {B[key].mean():.4f} "
              f"(diff {d:+.4f}, t={t:.2f}, p={pv:.2e}) -> {better}"
              f" {'(n.s.)' if pv > 0.05 else ''}")
    for nm, X in ((na, A), (nb, B)):
        ratio = float(estimator.diversity_ratio(
            X["d_ss"].mean(), X["d_yy"].mean(), X["M"]))
        floor = float(estimator.calibrated_floor(
            X["d_yy"].mean(), X["N"], X["M"]))
        print(f"  {nm}: d_sy {X['d_sy'].mean():.4f}  d_ss {X['d_ss'].mean():.4f}  "
              f"d_yy {X['d_yy'].mean():.4f}  ratio {ratio:.3f}  floor {floor:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
