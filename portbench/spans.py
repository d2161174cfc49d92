"""Reading the program's span log for the per-layer metrics in metrics/:
`phiseg_tpu_torch.utils.profiling.SPANS` holds the spans of the newest
torch.profiler session, here the traced units of a --trace 1 run. Each
record has a name, the wall-clock ends of the span in ns (`start_ns`,
`end_ns`), the calling thread's CPU ns over it (`cpu_ns`), CUDA (start, end)
events or None (`events`) and a reading its caller adds (`value`).

Host times are those of the traced window: torch.profiler adds its cost to
every op (about 2x on the train cell's window), so they compare one commit
with another, not with the untraced window's wall time.

Every function returns None where there is nothing to read: a run on the
CPU or without a trace, a program without the span log (an older commit),
or a log without the span asked for."""

from __future__ import annotations

from typing import List, Optional


def records(ctx, name: str) -> Optional[List[object]]:
    """The finished spans named `name` of the traced window, in the order
    they opened, or None."""
    if ctx.trace is None or ctx.device_name == "cpu":
        return None
    try:
        from phiseg_tpu_torch.utils import profiling
    except ImportError:
        return None
    log = getattr(profiling, "SPANS", None)
    if log is None:
        return None
    found = [r for r in log.records() if r.name == name]
    return found or None


def wall_ms_per_unit(ctx, name: str, unit: str) -> Optional[float]:
    """The wall ms of the spans `name`, summed, over the count of the spans
    `unit` (one a step or call)."""
    spans, units = records(ctx, name), records(ctx, unit)
    if spans is None or units is None:
        return None
    return sum(r.end_ns - r.start_ns for r in spans) / 1e6 / len(units)


def offcpu_ms(ctx, name: str) -> Optional[float]:
    """The mean over the spans `name` of their wall ms less the calling
    thread's CPU ms: the time the thread was off the CPU inside them."""
    spans = records(ctx, name)
    if spans is None:
        return None
    return sum((r.end_ns - r.start_ns) - r.cpu_ns for r in spans) / 1e6 / len(spans)


def value_rate_ms(ctx, name: str) -> Optional[float]:
    """The change of the spans' `value` (a clock in ns) from the first span
    to the last, over the spans between, in ms: per span."""
    values = [r.value for r in records(ctx, name) or () if r.value is not None]
    if len(values) < 2:
        return None
    return (values[-1] - values[0]) / 1e6 / (len(values) - 1)


def device_ms_per_image(ctx, name: str) -> Optional[float]:
    """The mean device ms between the CUDA events at the edges of the spans
    `name`, over the cell's batch."""
    spans = [r for r in records(ctx, name) or () if r.events is not None]
    if not spans:
        return None
    total = 0.0
    for r in spans:
        start, end = r.events
        end.synchronize()
        total += start.elapsed_time(end)
    return total / len(spans) / ctx.batch
