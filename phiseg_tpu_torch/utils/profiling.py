"""Profiling and tracing hooks (port of phiseg_tpu/utils/profiling.py).

The reference's only tracing is wall-clock logging of the validation pass
(phiseg/phiseg_model.py:559,636). Here: torch.profiler sessions written as
Chrome traces (chrome://tracing, Perfetto), plus timed sections.

Usage:
  PHISEG_PROFILE_DIR=/tmp/trace PHISEG_PROFILE_STEPS=5:10 python -m phiseg_tpu_torch.cli.train ...
traces train steps 5 to 10, both included, into /tmp/trace, or in code:

  with trace_if_enabled(device):           # env-gated
      ...
  with timed_section("validation"):        # wall-clock log
      ...

A session records the host's operator calls always, and the card's kernels,
copies and their times when it is given a CUDA device. It ends with a
synchronise, so every kernel queued in the window is in the trace, and
writes one trace file per session, `<label>.<pid>.trace.json`.
`summarize_trace` reads such a file back: the window, the device's busy
time in it, and the device time and calls of each kernel, copy and fill by
name.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

log = logging.getLogger(__name__)


def profile_config() -> Tuple[Optional[str], int, int]:
    """(dir, start_step, stop_step) from the environment, or (None, -1, -1)."""
    d = os.environ.get("PHISEG_PROFILE_DIR")
    if not d:
        return None, -1, -1
    steps = os.environ.get("PHISEG_PROFILE_STEPS", "2:7")
    start, stop = (int(x) for x in steps.split(":"))
    return d, start, stop


def _activities(device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


class ProfileSession:
    """One torch.profiler session that writes its Chrome trace into a
    directory: it starts when made, and `stop()` ends it and returns the
    trace's path."""

    def __init__(self, out_dir: str, label: str, device=None):
        self.device = device
        self.path = os.path.join(out_dir, f"{label}.{os.getpid()}.trace.json")
        os.makedirs(out_dir, exist_ok=True)
        self.prof = torch.profiler.profile(activities=_activities(device))
        self.prof.start()

    def stop(self) -> str:
        if self.device is not None and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        self.prof.export_chrome_trace(self.path)
        return self.path


class StepProfiler:
    """Start and stop a profiler session around a window of train steps,
    the steps start..stop of PHISEG_PROFILE_STEPS, both included: the loop
    calls maybe_start(step) before a step and maybe_stop(step) after it."""

    def __init__(self, device=None):
        self.dir, self.start_step, self.stop_step = profile_config()
        self.device = device
        self._session: Optional[ProfileSession] = None
        self.traces = []  # the trace files written

    @property
    def active(self) -> bool:
        return self._session is not None

    def maybe_start(self, step: int) -> None:
        if self.dir and self._session is None and step == self.start_step:
            self._session = ProfileSession(self.dir, f"steps{self.start_step}-{self.stop_step}",
                                     self.device)
            log.info("profiler: tracing steps %d..%d -> %s",
                     self.start_step, self.stop_step, self.dir)

    def maybe_stop(self, step: int) -> None:
        if self._session is not None and step >= self.stop_step:
            self.close()

    def close(self) -> None:
        """End an open session (a loop that stops inside the window) and
        write its trace."""
        if self._session is not None:
            path = self._session.stop()
            self._session = None
            self.traces.append(path)
            log.info("profiler: trace written to %s", path)


@contextlib.contextmanager
def trace_if_enabled(device=None, label: str = "trace"):
    """A profiler session around the block when PHISEG_PROFILE_DIR is set."""
    d, _, _ = profile_config()
    if not d:
        yield
        return
    session = ProfileSession(d, label, device)
    try:
        yield
    finally:
        log.info("profiler: trace written to %s", session.stop())


@contextlib.contextmanager
def timed_section(name: str):
    t0 = time.perf_counter()
    yield
    log.info("@ %s took: %.2f secs", name, time.perf_counter() - t0)


# a Chrome trace's device events: kernels, copies and fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_events(path: str) -> Tuple[List[dict], List[dict]]:
    """The complete ("X") events of a Chrome trace, and its device events."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    return events, [e for e in events if e.get("cat") in DEVICE_CATS]


def _busy_us(events: List[dict]) -> float:
    """Microseconds of the union of the events' [start, end): the time at
    least one of them ran."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for a, z in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, z
        else:
            cur_e = max(cur_e, z)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def summarize_trace(path: str) -> Dict[str, object]:
    """A trace's window (first event's start to last event's end), the
    device's busy and summed time in it, its kernel count, and `ops`: each
    device op's (name, self device us, calls), most time first. The device
    time of a kernel is its own; no CPU op is given its kernels' time."""
    events, device = trace_events(path)
    by_name: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    return {"window_us": hi - lo, "busy_us": _busy_us(device),
            "device_us": sum(e["dur"] for e in device),
            "kernels": sum(1 for e in device if e.get("cat") == "kernel"),
            "ops": sorted(((n, d, int(c)) for n, (d, c) in by_name.items()),
                          key=lambda t: -t[1])}


def launches_named(summary: Dict[str, object], fragment: str) -> int:
    """Calls of the device ops of a summary whose name holds `fragment`."""
    return sum(c for n, _, c in summary["ops"] if fragment in n)
