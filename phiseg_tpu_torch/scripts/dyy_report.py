"""Data-level annotator-diversity (d_yy) report for the synthetic tasks
(port of scripts/dyy_report.py: the same report, text for text).

Every cross-task GED^2 comparison needs the task's own annotator diversity
and the finite-sample estimator floor next to it. For each task this
measures, over the SAME deterministic test split the eval CLIs use
(SyntheticData seed=0 -> test seed=2, n=256, 128x128, 4 annotators) and
the SAME distance the GED uses (pairwise_iou_distance, label_range=(1,),
nlabels divisor 1):

  d_yy (incl. self)  -- (1/M^2) sum d(y,y'): the term the eval npz records;
  d-bar (excl. self) -- (1/(M(M-1))) sum_{i!=j} d(y,y'): the expected
                        distance between two independent annotator draws;
  floors             -- (1/N + 1/M) * d-bar for the protocols in use: a
                        model sampling EXACTLY from the annotator
                        distribution still scores this GED^2, because the
                        biased reference estimator (utils.py:294-322)
                        averages self-pairs into d_ss and d_yy.

Usage:
  python -m phiseg_tpu_torch dyy_report [--device cuda|cpu] [--out PATH]

Prints the report; writes it to a file only where --out says. `--device`
(default cuda; without a card that raises) is where the distances run.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

PROTOCOLS = [("val (N=16)", 16), ("test (N=50)", 50), ("dice (N=100)", 100)]
TASKS = ("nested", "multiscale", "bfield")


def task_distances(task: str, n_images: int, hw, m_annot: int, device):
    """Per test image of `task`: the mean annotator distance with and
    without self pairs, each (n,) f32."""
    from phiseg_tpu_torch.data.synthetic import get_task_generator
    from phiseg_tpu_torch.metrics import pairwise_iou_distance

    _, y = get_task_generator(task)(n_images, hw, m_annot, seed=2)  # (n, H, W, M)
    masks = torch.from_numpy(np.ascontiguousarray(np.transpose(y, (0, 3, 1, 2))))
    d = pairwise_iou_distance(masks.to(device=device, dtype=torch.int32),
                              masks.to(device=device, dtype=torch.int32), (1,), 1)  # (n,M,M)
    off = ~torch.eye(m_annot, dtype=torch.bool, device=d.device)
    return d.mean((-2, -1)).cpu().numpy(), d[:, off].mean(-1).cpu().numpy()


def report_lines(n_images: int = 256, hw=(128, 128), m_annot: int = 4, device="cuda"):
    from phiseg_tpu_torch.parallel.mesh import resolve_device

    device = resolve_device(device)
    lines = [
        f"Annotator-diversity report: test split seed=2, n={n_images}, "
        f"{hw[0]}x{hw[1]}, M={m_annot} annotators",
        "distance: 1 - IoU(fg), reference edge cases (both empty -> d=0, "
        "one empty -> d=1); label_range=(1,) as in the eval programs",
        "",
        f"{'task':<12}{'d_yy(incl self)':>18}{'d-bar(excl self)':>18}"
        + "".join(f"{'floor ' + name:>18}" for name, _ in PROTOCOLS),
    ]
    for task in TASKS:
        d_incl, d_excl = task_distances(task, n_images, hw, m_annot, device)
        row = (f"{task:<12}{d_incl.mean():>12.4f} ±{d_incl.std():<5.3f}"
               f"{d_excl.mean():>12.4f} ±{d_excl.std():<5.3f}")
        for _, n_s in PROTOCOLS:
            floor = (1.0 / n_s + 1.0 / m_annot) * d_excl.mean()
            row += f"{floor:>18.4f}"
        lines.append(row)
    return lines


def main(argv=None):
    """Print the report; returns its text."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the distances run; cuda without a card raises")
    p.add_argument("--out", default=None, help="also write the report to this file")
    a = p.parse_args(argv)
    text = "\n".join(report_lines(device=a.device)) + "\n"
    print(text, end="", flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text)
        print(f"wrote {a.out}")
    return text


if __name__ == "__main__":
    main()
