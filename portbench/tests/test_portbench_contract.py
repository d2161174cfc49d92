"""BENCHMARK.json against the benchmark's contract, and the files it names:
names, units, bounds, a reader for every metric, a traffic mix and limits
for every cell, every cell reporting setup_s, another end-to-end metric and
a per-layer one, and a full check of 24 cells at run_seconds fitting its
time."""

import json
import os
import re

import pytest

from portbench.cells import Bench
from portbench.tests.tiny import PKG, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_command(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    # a full check of 24 cells fits: 2 + 14 runs a cell, each run_seconds + 60,
    # 2 x 90 s a cell to compile, 1200 s spare
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["why"]) and _line(c["source"])
        assert c["file"].startswith("portbench/") and c["name"] in used
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        with open(os.path.join(ROOT, c["file"])) as f:
            doc = json.load(f)
        assert doc["source"] == c["source"] and doc["reduced"] == c["reduced"]
        # no width is cut
        assert not any(k.endswith(("_dim", "_rank")) or k in ("n0", "zdim0") for k in c["reduced"])


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(names) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(PKG, "traffic", f"{w['traffic']}.json"))
        with open(os.path.join(PKG, "limits", f"{w['name']}.json")) as f:
            limits = json.load(f)
        assert limits and all(v > 0 for v in limits.values())


def test_metrics(bench):
    e2e, layer = bench["end_to_end"], bench["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(set(names)) == len(names)
    assert 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    cells = {w["name"] for w in bench["workloads"]}
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in e2e)
    e2e_names = {m["name"] for m in e2e}
    for m in layer:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e_names and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = next(x for x in e2e if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(Bench(ROOT).reader_path(m["name"]))
    for cell in cells:
        mine = [m["name"] for m in e2e if cell in m.get("workloads", cells)]
        assert "setup_s" in mine and len(mine) >= 2, cell
        assert any(cell in m.get("workloads", cells) for m in layer), cell
    # one name per layer and spelling
    assert len({m["layer"] for m in layer}) == len({m["layer"].lower() for m in layer})
