"""The readers of the program's span log (portbench/spans.py and the
metrics that use it): nothing on the CPU, nothing without the log (a
program that has none, as an older commit) or with an empty one, the
arithmetic on a log made by hand, and the spans the readers name found in
the log of a tiny traced train loop."""

import os
import types

import pytest
import torch

from portbench.cells import Bench
from portbench.tests.tiny import ROOT, write_bench
from phiseg_tpu_torch.utils import profiling

torch.set_num_threads(1)

READERS = ["augment_host_ms.train", "forward_host_ms.train", "backward_host_ms.train",
           "optimizer_host_ms.train", "step_offcpu_ms.train", "prefetch_cpu_ms.train",
           "eval_metrics_device_ms.eval", "eval_metrics_device_ms.probunet_eval"]
MS = 1_000_000


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _rec(name, start_ms, wall_ms, cpu_ms=0.0, value=None, device_ms=None):
    events = None if device_ms is None else (_Event(0.0), _Event(device_ms))
    return types.SimpleNamespace(name=name, start_ns=int(start_ms * MS),
                                 end_ns=int((start_ms + wall_ms) * MS), cpu_ns=int(cpu_ms * MS),
                                 value=value, events=events)


def _log(records):
    return types.SimpleNamespace(records=lambda: list(records))


HAND = [
    _rec("data.wait", 0, 0.5, value=1 * MS),
    _rec("train_step", 1, 10, cpu_ms=6),
    _rec("train_step.augment", 1, 1), _rec("train_step.forward", 2, 3),
    _rec("train_step.backward", 5, 4), _rec("train_step.optimizer", 9, 1),
    _rec("data.wait", 11, 0.5, value=3 * MS),
    _rec("train_step", 12, 12, cpu_ms=7),
    _rec("train_step.augment", 12, 2), _rec("train_step.forward", 14, 4),
    _rec("train_step.backward", 18, 5), _rec("train_step.optimizer", 23, 1),
    _rec("data.wait", 24, 0.5, value=6 * MS),
    _rec("eval.sample", 30, 9, device_ms=80.0), _rec("eval.metrics", 39, 1, device_ms=4.0),
    _rec("eval.sample", 40, 9, device_ms=80.0), _rec("eval.metrics", 49, 1, device_ms=6.0),
]
WANT = {"augment_host_ms.train": 1.5, "forward_host_ms.train": 3.5,
        "backward_host_ms.train": 4.5, "optimizer_host_ms.train": 1.0,
        "step_offcpu_ms.train": 4.5, "prefetch_cpu_ms.train": 2.5,
        "eval_metrics_device_ms.eval": 5.0 / 8, "eval_metrics_device_ms.probunet_eval": 5.0 / 8}


def _ctx(device_name="NVIDIA H100 80GB HBM3", batch=8):
    return types.SimpleNamespace(device_name=device_name, trace={}, batch=batch)


@pytest.mark.parametrize("name", READERS)
def test_the_hand_made_log(name, monkeypatch):
    monkeypatch.setattr(profiling, "SPANS", _log(HAND))
    assert Bench(ROOT).reader(name)(_ctx()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", ["cpu", "untraced", "no_log", "empty_log"])
def test_nothing_to_read(name, case, monkeypatch):
    monkeypatch.setattr(profiling, "SPANS", _log([] if case == "empty_log" else HAND))
    if case == "no_log":
        monkeypatch.delattr(profiling, "SPANS")
    ctx = _ctx("cpu" if case == "cpu" else "NVIDIA H100 80GB HBM3")
    if case == "untraced":
        ctx.trace = None
    assert Bench(ROOT).reader(name)(ctx) is None


def test_a_traced_tiny_train_loop_has_every_span_read(tmp_path):
    """The names the readers read are the program's: a tiny train loop
    traced on the CPU gives each .train reader a number (the device reader
    stays None: no CUDA events on the CPU), the phases inside the step."""
    from portbench.loops import make_loop

    d = str(tmp_path)
    write_bench(d)
    bench = Bench(d, d)
    cell = bench.workload("phiseg_7_5-train")
    traffic = dict(bench.traffic(cell), warmup_units=1, traced_units=3)
    config = bench.config(cell)
    loop = make_loop(config["experiment"], traffic, 2 ** 31 + 9, "cpu", bench.reference(config))
    loop.setup()
    assert loop.traced(os.path.join(d, "t.json")) == 3
    loop.release()
    ctx = _ctx(batch=loop.batch)
    got = {name: Bench(ROOT).reader(name)(ctx) for name in READERS}
    assert all(got[name] > 0 for name in READERS if name.endswith(".train"))
    assert got["eval_metrics_device_ms.eval"] is None
    phases = sum(got[f"{p}_host_ms.train"] for p in ("augment", "forward", "backward", "optimizer"))
    steps = [r for r in profiling.SPANS.records() if r.name == "train_step"]
    assert len(steps) == 3
    assert phases <= sum(r.end_ns - r.start_ns for r in steps) / 1e6 / 3
