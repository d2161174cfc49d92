"""Profiling and tracing hooks (port of phiseg_tpu/utils/profiling.py).

The reference's only tracing is wall-clock logging of the validation pass
(phiseg/phiseg_model.py:559,636). Here: torch.profiler sessions written as
Chrome traces (chrome://tracing, Perfetto), and named spans of the port's
own work that land in those traces and in an in-process log.

Usage:
  PHISEG_PROFILE_DIR=/tmp/trace PHISEG_PROFILE_STEPS=5:10 python -m phiseg_tpu_torch.cli.train ...
traces train steps 5 to 10, both included, into /tmp/trace.

A session records the host's operator calls always, and the card's kernels,
copies and their times when it is given a CUDA device. It ends with a
synchronise, so every kernel queued in the window is in the trace, and
writes one trace file per session, `<label>.<pid>.trace.json`.
`summarize_trace` reads such a file back: the window, the device's busy
time in it, and the device time and calls of each kernel, copy and fill by
name.

Spans (`span(name, unit, device)`) mark the phases of the train step, the
sampler, the eval and the Trainer. With no profiler running a span is one
check and does nothing else. Under a torch.profiler session (any: the
Trainer's window, `profile_step`, a benchmark's) it is a `record_function`
in the Chrome trace and a `SpanRecord` in `SPANS`, the log of the newest
session: wall-clock ends in `time.time_ns()`, the trace's own clock, the
calling thread's CPU time, and with `device=` a CUDA device a pair of CUDA
events on its current stream, read only when the log is read.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import threading
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
        SPANS.end()
        self.prof.export_chrome_trace(self.path)
        return self.path


class StepProfiler:
    """Start and stop a profiler session around a window of train steps,
    the steps start..stop of PHISEG_PROFILE_STEPS, both included: the loop
    calls maybe_start(step) before a step and maybe_stop(step) at the end of
    the step's loop body, after its report, validation and checkpoints."""

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


# ---------------------------------------------------------------------------
# Spans

_profiler_enabled = torch._C._autograd._profiler_enabled  # a profiler on this thread


class SpanRecord:
    """One span of the log. `unit` is the step or call the span belongs to
    (its parent's where it has a parent), `parent` the record of the span
    open around it on its thread, `thread` that thread's ident. `start_ns`
    and `end_ns` (None while the span is open) are `time.time_ns()`, the
    clock of a Chrome trace's `ts + baseTimeNanoseconds / 1000`; `cpu_ns` is
    the calling thread's CPU time over the span; `events` the (start, end)
    CUDA events, or None; `value` a reading the span's caller adds
    (`data.wait`: the prefetch thread's CPU clock at entry, in ns)."""

    __slots__ = ("name", "unit", "parent", "thread", "start_ns", "end_ns", "cpu_ns", "events",
                 "value")

    def __init__(self, name: str, unit, parent: Optional["SpanRecord"], thread: int):
        self.name, self.unit, self.parent, self.thread = name, unit, parent, thread
        self.start_ns = self.end_ns = self.cpu_ns = self.events = self.value = None

    @property
    def wall_ns(self) -> int:
        return self.end_ns - self.start_ns

    def device_ms(self) -> Optional[float]:
        """Device ms between the span's events, once the second has run;
        None for a span without events."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


class SpanLog:
    """The spans of the newest tracing session, in the order they opened.
    The first span that finds a profiler running on its thread clears the
    log and makes it live; the first span on that thread that finds none,
    or the end of a ProfileSession, ends the session. While the log is
    live, spans on threads the profiler cannot see (a thread started before
    the session, such as the Trainer's prefetch thread) record too.
    Reading the log does not drain it. A profiler gives no session identity,
    so two torch.profiler sessions with no span on that thread between them
    (and no ProfileSession) share one log."""

    def __init__(self):
        self.live = False
        self.owner: Optional[int] = None  # the thread that made the log live
        self._records: List[SpanRecord] = []
        self._open = threading.local()  # each thread's stack of open spans

    def start(self) -> None:
        self._records = []
        self.owner = threading.get_ident()
        self.live = True

    def end(self) -> None:
        self.live = False

    def records(self) -> List[SpanRecord]:
        """The finished spans of the newest session."""
        return [r for r in self._records if r.end_ns is not None]

    def _stack(self) -> List[SpanRecord]:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack


SPANS = SpanLog()
_NOOP = contextlib.nullcontext()


class _Span:
    """A recording span: a record_function where the profiler sees the
    thread, a SpanRecord in the log, CUDA events on `device` if it is a
    CUDA device."""

    __slots__ = ("log", "name", "unit", "device", "traced", "rec", "rf", "cpu0")

    def __init__(self, log: SpanLog, name: str, unit, device, traced: bool):
        self.log, self.name, self.unit, self.traced = log, name, unit, traced
        self.device = device if device is not None and torch.device(device).type == "cuda" else None

    def _event(self) -> "torch.cuda.Event":
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def __enter__(self) -> SpanRecord:
        if self.traced:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        # the clocks first, next to the trace's own stamp
        start_ns, self.cpu0 = time.time_ns(), time.thread_time_ns()
        stack = self.log._stack()
        parent = stack[-1] if stack else None
        rec = self.rec = SpanRecord(self.name, self.unit if parent is None else parent.unit,
                                    parent, threading.get_ident())
        rec.start_ns = start_ns
        if self.device is not None:
            rec.events = (self._event(), None)
        stack.append(rec)
        self.log._records.append(rec)
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        if rec.events is not None:
            rec.events = (rec.events[0], self._event())
        self.log._stack().pop()
        rec.cpu_ns = time.thread_time_ns() - self.cpu0
        rec.end_ns = time.time_ns()
        if self.traced:
            self.rf.__exit__(*exc)
        return False


def span(name: str, unit=None, device=None):
    """A context manager that marks a phase of the port's work by `name`.
    `unit` identifies the step or call (a span inside another takes its
    parent's); `device` (a CUDA device) adds a pair of CUDA events on its
    current stream, never a synchronise. Off (no profiler on this thread
    and no live log) it is a shared no-op context, entered as None; on, it
    is entered as its SpanRecord (see SpanLog for when it is on)."""
    if _profiler_enabled():
        if not SPANS.live:
            SPANS.start()
        return _Span(SPANS, name, unit, device, True)
    if not SPANS.live:
        return _NOOP
    if threading.get_ident() == SPANS.owner:
        SPANS.end()
        return _NOOP
    return _Span(SPANS, name, unit, device, False)


def summarize_spans(records: List[SpanRecord]) -> List[Tuple[str, int, float, Optional[float]]]:
    """Per span name, in the order first opened: (name, calls, host ms, device
    ms or None where the spans have no events), summed over the records."""
    by_name: Dict[str, list] = {}
    for r in records:
        row = by_name.setdefault(r.name, [0, 0.0, None])
        row[0] += 1
        row[1] += r.wall_ns / 1e6
        d = r.device_ms()
        if d is not None:
            row[2] = (row[2] or 0.0) + d
    return [(name, calls, host, dev) for name, (calls, host, dev) in by_name.items()]


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
