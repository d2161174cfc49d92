"""Render a RESULTS.md-ready markdown table from eval npz artifacts (port of
scripts/results_table.py, whose printed text it gives byte for byte).

Reads the eval CLIs' npz files (ged{N}_{tag}, ncc{N}_{tag}, dice_{tag})
for a set of experiment log dirs and prints one markdown table row per
experiment: biased GED^2 (the reference estimator), unbiased GED^2
(self-pair-corrected, from the embedded term decomposition), S_NCC, fg
Dice -- plus the per-task calibrated-model floor line. The files are the
ones `phiseg_tpu_torch.cli.test_quantitative` / `test_predictions` write,
or the JAX package's: the two share the format.

Usage:
  python -m phiseg_tpu_torch results_table lidc_bf/phiseg_7_5_bf lidc_bf/probunet_bf \
      lidc_bf/phiseg_7_1_bf lidc2_bf/detunet_bf [--suffix _48k]
(paths relative to $PHISEG_LOG_ROOT or ./logs; the experiment name is the
basename). detunet rows suppress S_NCC (degenerate for a deterministic
model). Pure numpy: no device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from phiseg_tpu_torch.engine.config import log_root
from phiseg_tpu_torch.metrics import estimator


def load_row(log_dir: str, samples: int, dice_samples: int, tag: str,
             suffix: str = ""):
    row = {"name": os.path.basename(log_dir.rstrip("/"))}
    ged_f = os.path.join(log_dir, f"ged{samples}_{tag}{suffix}.npz")
    if os.path.exists(ged_f):
        with np.load(ged_f) as z:
            ged = np.asarray(z["arr_0"])
            row["ged"] = (ged.mean(), ged.std(), len(ged))
            if all(k in z for k in ("d_sy", "d_ss", "d_yy", "n_samples",
                                    "n_annotators")):
                n_s, n_a = int(z["n_samples"]), int(z["n_annotators"])
                ub = estimator.unbiased_ged(
                    z["d_sy"], z["d_ss"], z["d_yy"], n_s, n_a)
                row["ged_ub"] = (float(ub.mean()), float(ub.std()))
                row["floor"] = float(
                    estimator.calibrated_floor(z["d_yy"], n_s, n_a).mean())
                row["terms"] = (float(z["d_sy"].mean()),
                                float(z["d_ss"].mean()),
                                float(z["d_yy"].mean()))
    ncc_f = os.path.join(log_dir, f"ncc{samples}_{tag}{suffix}.npz")
    if os.path.exists(ncc_f):
        with np.load(ncc_f) as z:
            ncc = np.asarray(z["arr_0"])
            row["ncc"] = (ncc.mean(), ncc.std(), len(ncc))
    dice_f = os.path.join(log_dir, "dice_best_dice.npz")
    if os.path.exists(dice_f):
        with np.load(dice_f) as z:
            d = np.asarray(z["arr_0"])
            if d.ndim == 2:
                d = d[:, 1:].mean(axis=1)  # foreground mean
            row["dice"] = (d.mean(), d.std(), len(d))
    return row


def fmt(v):
    return f"{v[0]:.3f} ± {v[1]:.3f}" if v else "—"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("dirs", nargs="+", help="log dirs (relative to log root)")
    p.add_argument("--samples", type=int, default=50)
    p.add_argument("--dice-samples", type=int, default=100)
    p.add_argument("--tag", default="best_ged")
    p.add_argument("--suffix", default="")
    a = p.parse_args(argv)

    root = log_root()
    rows = []
    for d in a.dirs:
        full = d if os.path.isabs(d) else os.path.join(root, d)
        rows.append(load_row(full, a.samples, a.dice_samples, a.tag, a.suffix))

    n = next((r["ged"][2] for r in rows if "ged" in r), "?")
    print(f"| experiment (n={n}) | GED² ↓ | GED² unbiased ↓ | S_NCC ↑ | fg Dice ↑ |")
    print("|---|---|---|---|---|")
    for r in rows:
        det = r["name"].startswith("detunet")
        print("| {} | {} | {} | {} | {} |".format(
            r["name"], fmt(r.get("ged")),
            fmt(r.get("ged_ub")),
            "—*" if det else fmt(r.get("ncc")),
            fmt(r.get("dice"))))
    for r in rows:
        if "floor" in r:
            t = r.get("terms")
            print(f"floor({r['name']}): {r['floor']:.4f}"
                  + (f"  d_sy {t[0]:.4f} d_ss {t[1]:.4f} d_yy {t[2]:.4f}"
                     if t else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
