"""Finite-sample corrections for the biased GED^2 estimator (pure numpy).

A copy of phiseg_tpu/metrics/estimator.py: the port imports nothing of the
JAX package, whose package `__init__`s import jax.

The reference's GED^2 estimator (ref utils.py:294-322) averages pairwise
distances INCLUDING zero-distance self-pairs, so a model that samples
exactly from the annotator distribution still scores a positive GED^2 of
(1/N + 1/M) * d-bar at N samples / M annotators (the "calibrated-model
floor"), and the estimator structurally favors under-dispersed samplers
(its inflation term + d_ss/N + d_yy/M shrinks with d_ss).  This module is
the single implementation of the corrections; both results-aggregation
tools (`phiseg_tpu.cli.eval_plots` and `scripts/pair_stats.py`) import it
so the two printouts can never drift (VERDICT r4 weak #5 — the same class
of bug as the round-3 duplicated lr schedule).

Degenerate protocols are well-defined rather than crashes (ADVICE r4):
with a single sample (N=1) or a single annotator (M=1) the corresponding
diversity term is exactly zero by construction, the self-pair-exclusion
factor is undefined, and the corrected quantities are reported as NaN.

All headline tables keep the reference's *biased* estimator for parity;
these corrections are diagnostics.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "annotator_dbar",
    "calibrated_floor",
    "diversity_ratio",
    "unbiased_ged",
]


def _excl_factor(k: int) -> float:
    """Self-pair-exclusion factor k/(k-1); NaN for k<=1 (undefined)."""
    return k / (k - 1.0) if k > 1 else float("nan")


def annotator_dbar(d_yy, n_annotators: int):
    """Population mean annotator distance excluding self-pairs.

    The npz `d_yy` term averages over all M^2 ordered pairs incl. the M
    zero-distance self-pairs, so d-bar = d_yy * M/(M-1).  NaN when M=1
    (inter-annotator distance is undefined with one rater).
    """
    return np.asarray(d_yy, dtype=np.float64) * _excl_factor(n_annotators)


def calibrated_floor(d_yy, n_samples: int, n_annotators: int):
    """GED^2 of a perfectly calibrated sampler under the biased estimator.

    E[d_sy] = d-bar, E[d_ss] = (1 - 1/N) d-bar, E[d_yy] = (1 - 1/M) d-bar,
    so E[GED^2] = (1/N + 1/M) * d-bar.  Compare models against this floor,
    not against 0.  NaN when M=1.
    """
    dbar = annotator_dbar(d_yy, n_annotators)
    return (1.0 / n_samples + 1.0 / n_annotators) * dbar


def unbiased_ged(d_sy, d_ss, d_yy, n_samples: int, n_annotators: int):
    """Self-pair-corrected GED^2: 2 d_sy - d_ss N/(N-1) - d_yy M/(M-1).

    Since d(s,s)=0, excluding self-pairs rescales the diversity terms; the
    calibrated floor then vanishes and the biased estimator's structural
    favor toward under-dispersed models is removed.  Element-wise over
    per-image term arrays.  NaN when N=1 or M=1 (correction undefined; the
    1annot experiments evaluate against a single rater *set* of M=4, so in
    practice M=4 everywhere — the guard is for future protocols).
    """
    d_sy = np.asarray(d_sy, dtype=np.float64)
    d_ss = np.asarray(d_ss, dtype=np.float64)
    d_yy = np.asarray(d_yy, dtype=np.float64)
    return (2.0 * d_sy
            - d_ss * _excl_factor(n_samples)
            - d_yy * _excl_factor(n_annotators))


def diversity_ratio(d_ss, d_yy, n_annotators: int):
    """Population-corrected sample/annotator diversity ratio.

    d_ss / (d_yy M/(M-1)): 1.0 = the sampler disperses exactly as much as
    the annotator population (calibrated); <1 under-dispersed.  This is
    the convention used throughout RESULTS.md: only the annotator term is
    population-corrected (at the N=50 test protocol the omitted sample-
    side factor N/(N-1) is a 2% effect).  NaN when M=1.
    """
    den = annotator_dbar(d_yy, n_annotators)
    return np.asarray(d_ss, dtype=np.float64) / np.maximum(den, 1e-12)
