"""The harness end to end on the CPU at a tiny size: a configuration and a
traffic file dropped into a directory run as a new cell with no code
edited; without a card the command exits non-zero and prints no result;
no run loads jax, jaxlib, flax, optax or phiseg_tpu (by whole top-level
name), and the reference imports nothing of the program."""

import ast
import glob
import json
import os
import subprocess
import sys

import torch

from portbench.tests.tiny import PKG, ROOT, write_bench

torch.set_num_threads(1)


def test_a_new_cell_from_files_alone(tmp_path):
    from portbench import run

    bench = write_bench(str(tmp_path))
    # a new configuration and a new traffic mix, named only by files and entries
    with open(tmp_path / "configs" / "phiseg_7_5.json") as f:
        doc = json.load(f)
    doc["experiment"]["latent_levels"] = 2
    with open(tmp_path / "configs" / "phiseg_7_2_tiny.json", "w") as f:
        json.dump(doc, f)
    traffic = {"kind": "sample", "batch": 2, "samples": 3, "warmup_units": 1, "traced_units": 2,
               "check_units": 2}
    with open(tmp_path / "traffic" / "sample_b2_s3.json", "w") as f:
        json.dump(traffic, f)
    with open(tmp_path / "limits" / "phiseg_7_2_tiny-sample_b2.json", "w") as f:
        json.dump({"prob_gap": 0.06}, f)
    bench["configs"].append(dict(bench["configs"][0], name="phiseg_7_2_tiny",
                                 file="configs/phiseg_7_2_tiny.json"))
    bench["workloads"].append({"name": "phiseg_7_2_tiny-sample_b2", "config": "phiseg_7_2_tiny",
                               "traffic": "sample_b2_s3", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sample_p95_ms" in (m["name"], m.get("moves")):
            m["workloads"].append("phiseg_7_2_tiny-sample_b2")
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    for trace in (False, True):
        result, checks = run.run_cell("phiseg_7_2_tiny-sample_b2", 2 ** 31 + 5, 0.5, trace,
                                      device="cpu", root=str(tmp_path), pkg=str(tmp_path))
        assert result["correct"] and result["attempted"] > 0
        assert [k for k, _, _ in checks] == ["prob_gap"]
        assert list(result)[-1] == "compared"
    assert set(result["metrics"]) == set()  # a CPU trace holds no device time to read
    assert result["breakdown"] == {"device_ops": [], "idle_gaps": []}


def _command(*args, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    proc = _command("--workload", "phiseg_7_5-train", "--seed", str(2 ** 31 + 11), "--seconds",
                    "1", "--trace", "0")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_without_the_program_no_result(tmp_path):
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _command("--workload", "phiseg_7_5-sample_b1", "--seed", "3", "--seconds", "1",
                    "--trace", "0", cwd=str(tmp_path))
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    from portbench.run import forbidden_loaded

    before = forbidden_loaded()
    for name in ("phiseg_tpu_torch", "phiseg_tpu_torch.engine", "jaxtyping", "optaxx"):
        monkeypatch.setitem(sys.modules, name, object())
    assert forbidden_loaded() == before
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert "flax" in forbidden_loaded()


def test_the_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(PKG, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:  # the references' own package (Adam) is the harness's
                assert n.split(".")[0] in ("torch", "math", "typing", "__future__", "numpy") \
                    or n == "portbench.reference", (path, n)


SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "phiseg_tpu"):
    sys.modules[name] = None  # importing any of these now fails
import json, tempfile, torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
from portbench.tests.tiny import write_bench
from portbench import run
d = tempfile.mkdtemp()
write_bench(d)
result, _ = run.run_cell("phiseg_7_5-train", 7, 0.3, False, device="cpu", root=d, pkg=d)
loaded = [m for m in sys.modules if sys.modules[m] is not None]
bad = sorted({m.split(".")[0] for m in loaded} & {"jax", "jaxlib", "flax", "optax", "phiseg_tpu"})
print(json.dumps({"correct": result["correct"], "bad": bad}))
"""


def test_a_run_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT, ROOT], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "bad": []}
