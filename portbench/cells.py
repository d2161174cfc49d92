"""Finding a cell's parts by name: BENCHMARK.json's entries, the
configuration's file, its plain model reference `reference/<name>.py` (the
file's "reference", else "model"), the traffic mix `traffic/<name>.json`,
the limits of its comparison `limits/<cell>.json`, and each metric's reader
`metrics/<metric>.py`, or `metrics/<stem>.py` for a metric `<stem>.<part>`
that has no file of its own (one reader for every cell kind). A new cell,
metric or model family is new files and entries; no code here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Callable, Dict, List, Optional

from portbench.reference import REQUIRED

HERE = os.path.dirname(os.path.abspath(__file__))
_REFERENCES: Dict[str, ModuleType] = {}  # by path: the reference modules loaded


class Bench:
    """BENCHMARK.json at `root` and the files it names; a cell's traffic,
    limits and metric readers are looked up under `pkg`, then under this
    package's directory."""

    def __init__(self, root: str, pkg: Optional[str] = None):
        self.root = root
        self.pkg = pkg or HERE
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def _named(self, key: str, name: str) -> dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no {key} entry named {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, workload: dict) -> dict:
        """The configuration file's content; "experiment" holds the
        program's config fields as they are run."""
        entry = self._named("configs", workload["config"])
        with open(os.path.join(self.root, entry["file"])) as f:
            return json.load(f)

    def _find(self, sub: str, filename: str) -> str:
        """sub/filename under `pkg`, else under this package."""
        for base in (self.pkg, HERE):
            path = os.path.join(base, sub, filename)
            if os.path.exists(path):
                return path
        raise FileNotFoundError(f"no {sub}/{filename} in {self.pkg} or {HERE}")

    def _json(self, sub: str, name: str) -> dict:
        with open(self._find(sub, f"{name}.json")) as f:
            return json.load(f)

    def reference(self, config: dict) -> ModuleType:
        """The plain model reference that a configuration's file names (see
        portbench/reference/__init__.py), loaded by its path once a process."""
        name = config.get("reference", "model")
        if not name.isidentifier():
            raise ValueError(f"a reference is named by a module name, not {name!r}")
        path = self._find("reference", f"{name}.py")
        if path not in _REFERENCES:
            spec = importlib.util.spec_from_file_location(
                f"portbench_reference_{len(_REFERENCES)}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            missing = [f for f in REQUIRED if not hasattr(mod, f)]
            if missing:
                raise AttributeError(f"reference {path} lacks {missing}")
            _REFERENCES[path] = mod
        return _REFERENCES[path]

    def traffic(self, workload: dict) -> dict:
        return self._json("traffic", workload["traffic"])

    def limits(self, workload: dict) -> Dict[str, float]:
        return self._json("limits", workload["name"])

    def metrics_for(self, workload: dict, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (trace off) or per-layer ones (on):
        those whose `workloads` list holds it, or that have no such list."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.spec[key]
                if "workloads" not in m or workload["name"] in m["workloads"]]

    def reader_path(self, metric: str) -> str:
        """metrics/<metric>.py, else metrics/<stem>.py, where the stem is the
        metric's name before its first dot."""
        try:
            return self._find("metrics", f"{metric}.py")
        except FileNotFoundError:
            return self._find("metrics", metric.split(".")[0] + ".py")

    def reader(self, metric: str) -> Callable:
        """The metric's reader's read(ctx) -> value or None."""
        path = self.reader_path(metric)
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
