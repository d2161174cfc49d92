"""The reference's script names as subcommands of the port.

  python -m phiseg_tpu_torch phiseg_train phiseg_7_5 [--device cpu] ...
  python -m phiseg_tpu_torch eval_ged_plot --files a/ged50_best_ged.npz ...
  python -m phiseg_tpu_torch results_table lidc_bf/phiseg_7_5_bf ... --suffix _48k

The reference-compatible root scripts (`phiseg_train.py`, `eval_ged_plot.py`,
...) forward to the JAX package; here each of their names forwards its
arguments to the port's CLI of the same job, and the names of the results
tools under `scripts/` to their ports in `phiseg_tpu_torch.scripts`.
`--help` lists the names; every subcommand takes its own `--help`.
"""

from __future__ import annotations

import importlib
import sys
from typing import Dict, Optional, Sequence, Tuple

# name -> (module whose main(argv) runs it, arguments put before the caller's)
COMMANDS: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "phiseg_train": ("phiseg_tpu_torch.cli.train", ()),
    "phiseg_test_quantitative": ("phiseg_tpu_torch.cli.test_quantitative", ()),
    "phiseg_test_predictions": ("phiseg_tpu_torch.cli.test_predictions", ()),
    "phiseg_generate_samples": ("phiseg_tpu_torch.cli.generate_samples", ()),
    "phiseg_sample_construction": ("phiseg_tpu_torch.cli.sample_construction", ()),
    "phiseg_makegif_samples": ("phiseg_tpu_torch.cli.makegif_samples", ()),
    "eval_ged_plot": ("phiseg_tpu_torch.cli.eval_plots", ("ged",)),
    "eval_ncc_plot": ("phiseg_tpu_torch.cli.eval_plots", ("ncc",)),
    "eval_dice_plot": ("phiseg_tpu_torch.cli.eval_plots", ("dice",)),
    "results_table": ("phiseg_tpu_torch.scripts.results_table", ()),
    "pair_stats": ("phiseg_tpu_torch.scripts.pair_stats", ()),
    "ged_decomposition": ("phiseg_tpu_torch.scripts.ged_decomposition", ()),
    "dyy_report": ("phiseg_tpu_torch.scripts.dyy_report", ()),
    "profile_step": ("phiseg_tpu_torch.scripts.profile_step", ()),
}


def usage() -> str:
    lines = ["usage: python -m phiseg_tpu_torch <command> [arguments]", "", "commands:"]
    lines += [f"  {name:28s} {module}" + (f" {' '.join(pre)}" if pre else "")
              for name, (module, pre) in COMMANDS.items()]
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None):
    """Run the named command on the rest of argv; returns what its main
    returns. An unknown name exits with status 2 and the list of names."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(usage())
        if not argv:
            raise SystemExit(2)
        return None
    name, rest = argv[0], argv[1:]
    if name not in COMMANDS:
        print(f"unknown command {name!r}\n\n{usage()}", file=sys.stderr)
        raise SystemExit(2)
    module, pre = COMMANDS[name]
    return importlib.import_module(module).main([*pre, *rest])


if __name__ == "__main__":
    main()
