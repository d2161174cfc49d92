"""Results aggregation: mean +- std, paired t-tests, boxplots (a copy of
phiseg_tpu/cli/eval_plots.py, which is numpy and scipy only, reading the
finite-N/M estimator from the port's own copy of metrics/estimator.py).

Equivalent of `eval_ged_plot.py` / `eval_ncc_plot.py` / `eval_dice_plot.py`
(ref eval_ged_plot.py:8-46): load per-experiment npz result arrays (written
by the eval CLIs), print mean +- std per experiment, run pairwise paired
t-tests (scipy.stats.ttest_rel) and optionally save a boxplot.

Usage:
  python -m phiseg_tpu_torch.cli.eval_plots ged --files lidc/phiseg_7_5/ged50_best_ged.npz \
      lidc/probunet/ged50_best_ged.npz --names phiseg probunet --plot out.png
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

log = logging.getLogger(__name__)


def aggregate(metric: str, files, names=None, plot: str | None = None):
    from scipy import stats

    names = names or [f"exp{i}" for i in range(len(files))]
    arrays, terms = [], []
    results_unbiased: dict = {}
    for f in files:
        with np.load(f) as z:
            # arr_0 = the positional result array (reference npz contract);
            # ged npz may carry extra named keys (GED term decomposition)
            arr = z["arr_0"] if "arr_0" in z else z[list(z.keys())[0]]
            t = ({k: z[k] for k in ("d_sy", "d_ss", "d_yy")}
                 if all(k in z for k in ("d_sy", "d_ss", "d_yy")) else None)
            if t is not None and "n_samples" in z and "n_annotators" in z:
                t["n_samples"] = int(z["n_samples"])
                t["n_annotators"] = int(z["n_annotators"])
        if metric == "dice" and arr.ndim == 2:
            arr = arr[:, 1:].mean(axis=1)  # foreground mean (ref eval_dice_plot.py:29)
        arrays.append(np.asarray(arr).ravel())
        terms.append(t)

    for name, arr, t in zip(names, arrays, terms):
        log.info("%s %s: %.4f +- %.4f (n=%d)", metric, name, arr.mean(), arr.std(), len(arr))
        if t is not None:
            log.info("  GED terms %s: fit d_sy %.4f | sample div d_ss %.4f | "
                     "annotator div d_yy %.4f (ss/yy %.3f)", name,
                     t["d_sy"].mean(), t["d_ss"].mean(), t["d_yy"].mean(),
                     t["d_ss"].mean() / max(t["d_yy"].mean(), 1e-12))
            if "n_samples" in t:
                # Single implementation of the finite-N/M corrections
                # (floor / unbiased GED^2) shared with scripts/pair_stats.py
                # -- see phiseg_tpu_torch/metrics/estimator.py for the math.
                # Diagnostics only: the headline tables keep the
                # reference's biased estimator (utils.py:294-322) for
                # parity. Degenerate protocols (N=1 or M=1) report NaN
                # with a note instead of a bogus correction.
                from phiseg_tpu_torch.metrics import estimator

                n_s, n_a = t["n_samples"], t["n_annotators"]
                floor = float(estimator.calibrated_floor(
                    t["d_yy"].mean(), n_s, n_a))
                if np.isnan(floor):
                    log.info("  estimator corrections undefined at N=%d, "
                             "M=%d (need N>1 and M>1); skipping "
                             "floor/unbiased diagnostics", n_s, n_a)
                    continue
                log.info("  calibrated-model GED^2 floor (N=%d, M=%d): %.4f "
                         "(achieved %.4f = floor + %.4f)",
                         n_s, n_a, floor, arr.mean(), arr.mean() - floor)
                ub = estimator.unbiased_ged(
                    t["d_sy"], t["d_ss"], t["d_yy"], n_s, n_a)
                log.info("  unbiased GED^2 %s: %.4f +- %.4f", name,
                         ub.mean(), ub.std())
                results_unbiased[name] = ub

    results = {"means": {n: float(a.mean()) for n, a in zip(names, arrays)},
               "stds": {n: float(a.std()) for n, a in zip(names, arrays)},
               "unbiased_means": {n: float(a.mean())
                                  for n, a in results_unbiased.items()},
               "ttests": {}, "ttests_unbiased": {}}
    ub_names = list(results_unbiased)
    for i in range(len(ub_names)):
        for j in range(i + 1, len(ub_names)):
            a, b = results_unbiased[ub_names[i]], results_unbiased[ub_names[j]]
            if len(a) == len(b):
                t, p = stats.ttest_rel(a, b)
                results["ttests_unbiased"][f"{ub_names[i]} vs {ub_names[j]}"] = (
                    float(t), float(p))
                log.info("paired t-test (unbiased GED^2) %s vs %s: t=%.3f p=%.2e",
                         ub_names[i], ub_names[j], t, p)
    for i in range(len(arrays)):
        for j in range(i + 1, len(arrays)):
            if len(arrays[i]) == len(arrays[j]):
                t, p = stats.ttest_rel(arrays[i], arrays[j])
                results["ttests"][f"{names[i]} vs {names[j]}"] = (float(t), float(p))
                log.info("paired t-test %s vs %s: t=%.3f p=%.2e",
                         names[i], names[j], t, p)
            else:
                log.warning("skipping t-test %s vs %s: unequal n", names[i], names[j])

    if plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(1.5 * len(arrays) + 1, 4))
        ax.boxplot(arrays, tick_labels=names)
        ax.set_ylabel(metric)
        fig.savefig(plot, dpi=150, bbox_inches="tight")
        plt.close(fig)
        log.info("wrote %s", plot)
    return results


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("metric", choices=["ged", "ncc", "dice"])
    p.add_argument("--files", nargs="+", required=True)
    p.add_argument("--names", nargs="*", default=None)
    p.add_argument("--plot", default=None)
    a = p.parse_args(argv)
    aggregate(a.metric, a.files, a.names, a.plot)


if __name__ == "__main__":
    main()
