"""The benchmark's reader of torch.profiler Chrome traces: the traced window,
the device's busy time in it (the union of its kernels', copies' and fills'
intervals), the kernel count, each device op's self time by name, and the
idle gaps between device work named by the host op that was running in them.

Frozen here so that a change to the program cannot change how its time is
read; the reading is that of phiseg_tpu_torch/utils/profiling.py's
`summarize_trace` and `_busy_us`.
"""

from __future__ import annotations

import collections
import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host events that name what the host was doing (not the launch calls themselves)
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def _spans(events: List[dict]) -> List[Tuple[float, float]]:
    """The union of the events' [start, end) as sorted disjoint spans (us)."""
    out: List[List[float]] = []
    for a, z in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], z)
        else:
            out.append([a, z])
    return [(a, z) for a, z in out]


def _main_thread(events: List[dict]) -> object:
    """The thread that launched the most device work: the loop's thread."""
    launches = collections.Counter(e.get("tid") for e in events if e.get("cat") == "cuda_runtime")
    return launches.most_common(1)[0][0] if launches else None


def _host_ops_at(host: List[dict], times: List[float]) -> List[str]:
    """For each of the ascending `times`, the innermost of the nested host
    ops (sorted by start) running then, or "idle host"."""
    names, stack, j = [], [], 0
    for t in times:
        while j < len(host) and host[j]["ts"] <= t:
            e = host[j]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            stack.append(e)
            j += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= t:
            stack.pop()
        names.append(stack[-1]["name"] if stack else "idle host")
    return names


def summarize(path: str, top: int = 10) -> Dict[str, object]:
    """window_us, busy_us, kernels, `ops` [(name, self device us, calls)]
    most time first, and `gaps` [(host op, idle us)]: the idle time between
    device spans, summed by the host op running at each gap's midpoint,
    most time first (`top` of each)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    by_name: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        by_name[e["name"]][0] += e["dur"]
        by_name[e["name"]][1] += 1
    spans = _spans(device)
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    tid = _main_thread(events)
    host = sorted((e for e in events if e.get("cat") in HOST_CATS and e.get("tid") == tid),
                  key=lambda e: (e["ts"], -e["dur"]))
    holes = [(z0, a1) for (_, z0), (a1, _) in zip(spans, spans[1:])]
    gaps: Dict[str, float] = collections.defaultdict(float)
    for (z0, a1), name in zip(holes, _host_ops_at(host, [(z0 + a1) / 2.0 for z0, a1 in holes])):
        gaps[name] += a1 - z0
    return {
        "window_us": hi - lo,
        "busy_us": sum(z - a for a, z in spans),
        "kernels": sum(1 for e in device if e.get("cat") == "kernel"),
        "ops": sorted(((n, d, int(c)) for n, (d, c) in by_name.items()), key=lambda t: -t[1]),
        "gaps": sorted(gaps.items(), key=lambda t: -t[1])[:top],
    }


def op_time_us(summary: Dict[str, object], fragment: str) -> Tuple[float, int]:
    """(device us, calls) of the ops whose name holds `fragment`."""
    hits = [(d, c) for n, d, c in summary["ops"] if fragment in n]
    return sum(d for d, _ in hits), sum(c for _, c in hits)
