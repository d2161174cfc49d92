"""graph_replay_pct.train, the share of the traced window's train steps that
replayed a CUDA graph: 100 x the `train_step.replay` spans over the
`train_step` spans, on logs made by hand; None where no step replayed (an
eager step, a program without the graph), on the CPU, untraced, and
without a log or with an empty one."""

import types

import pytest

from portbench.cells import Bench
from portbench.tests.tiny import ROOT
from phiseg_tpu_torch.utils import profiling

NAME = "graph_replay_pct.train"


def _rec(name, start_ms, wall_ms=1.0):
    return types.SimpleNamespace(name=name, start_ns=int(start_ms * 1e6),
                                 end_ns=int((start_ms + wall_ms) * 1e6), cpu_ns=0, value=None,
                                 events=None)


def _log(records):
    return types.SimpleNamespace(records=lambda: list(records))


def _ctx(device_name="NVIDIA H100 80GB HBM3"):
    return types.SimpleNamespace(device_name=device_name, trace={}, batch=12)


STEPS = [_rec("train_step", 10 * i, 9) for i in range(4)]
PHASES = [_rec(f"train_step.{p}", 10 * i + 1) for i in range(4)
          for p in ("augment", "forward", "backward", "optimizer")]
REPLAYS = [_rec("train_step.replay", 10 * i + 1) for i in range(4)]


@pytest.mark.parametrize("log,want", [
    ("eager", None),                 # the phases' spans, no replay
    ("replays", 100.0),              # every step a replay
    ("capture_then_replays", 100.0),  # the first step captures, then replays too
    ("eager_then_replays", 50.0),    # two eager steps, then two replays
])
def test_the_share_of_replays(log, want, monkeypatch):
    records = {"eager": STEPS + PHASES, "replays": STEPS + REPLAYS,
               "capture_then_replays": STEPS + [_rec("train_step.capture", 0)] + REPLAYS,
               "eager_then_replays": STEPS + PHASES[:8] + REPLAYS[2:]}[log]
    monkeypatch.setattr(profiling, "SPANS", _log(records))
    assert Bench(ROOT).reader(NAME)(_ctx()) == want


@pytest.mark.parametrize("case", ["cpu", "untraced", "no_log", "empty_log"])
def test_nothing_to_read(case, monkeypatch):
    monkeypatch.setattr(profiling, "SPANS", _log([] if case == "empty_log" else STEPS + REPLAYS))
    if case == "no_log":
        monkeypatch.delattr(profiling, "SPANS")
    ctx = _ctx("cpu" if case == "cpu" else "NVIDIA H100 80GB HBM3")
    if case == "untraced":
        ctx.trace = None
    assert Bench(ROOT).reader(NAME)(ctx) is None
