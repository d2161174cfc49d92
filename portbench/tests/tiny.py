"""A tiny copy of the benchmark's cells, written into a directory, for the
CPU tests: the cells' configurations at R=5, n0=4, 32x32 (SHRINK), then a
configuration file's own "tiny" overrides where it has them, else its
family's in FAMILY_TINY (L=3 for PHiSeg), in float32 or the cell's own
bfloat16, with the cells' traffic at a small batch and few samples, and the
committed limits."""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)

SHRINK = {"resolution_levels": 5, "n0": 4, "image_size": [32, 32, 1], "batch_size": 4,
          "synth_n_train": 16, "synth_n_test": 8}
# the overrides of a family whose configuration file has no "tiny" of its own
FAMILY_TINY = {"phiseg": {"latent_levels": 3}}


def tiny_experiment(doc: dict, compute_dtype: str = "float32") -> dict:
    """A configuration file's experiment, shrunk: SHRINK and the compute
    dtype, then the file's "tiny" object, or its family's FAMILY_TINY."""
    exp = dict(doc["experiment"], **SHRINK, compute_dtype=compute_dtype)
    exp.update(doc.get("tiny", FAMILY_TINY.get(exp["model_family"], {})))
    return exp


def write_bench(d: str, compute_dtype: str = "float32", limits_from=None) -> dict:
    """BENCHMARK.json, configs/, traffic/ and limits/ for tiny twins of the
    committed cells under `d`; returns the parsed BENCHMARK.json."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            doc = json.load(f)
        doc["experiment"] = tiny_experiment(doc, compute_dtype)
        c["file"] = f"configs/{c['name']}.json"
        with open(os.path.join(d, c["file"]), "w") as f:
            json.dump(doc, f)
    for name in {w["traffic"] for w in bench["workloads"]}:
        with open(os.path.join(PKG, "traffic", f"{name}.json")) as f:
            t = json.load(f)
        t.update(batch=4 if t["kind"] == "train" else min(t["batch"], 2),
                 samples=min(t.get("samples", 0), 5), warmup_units=1, traced_units=2)
        with open(os.path.join(d, "traffic", f"{name}.json"), "w") as f:
            json.dump(t, f)
    for w in bench["workloads"]:
        with open(os.path.join(limits_from or PKG, "limits", f"{w['name']}.json")) as f:
            lim = json.load(f)
        with open(os.path.join(d, "limits", f"{w['name']}.json"), "w") as f:
            json.dump(lim, f)
    with open(os.path.join(d, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return bench
