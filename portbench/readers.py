"""Arithmetic shared by the metric readers in metrics/: each reader is a
file of its own, found by its metric's name, that calls these on the run's
Context (run.py). A reader that finds nothing to read returns None."""

from __future__ import annotations

from typing import Optional


def images_per_s(ctx) -> float:
    """Images completed over all the untraced window's seconds."""
    return ctx.images / ctx.seconds


def wall_ms_per_unit(ctx) -> float:
    return 1000.0 * ctx.seconds / ctx.units


def device_ms_per_unit(ctx) -> Optional[float]:
    """Device-busy ms per unit in the trace: the union of its kernels',
    copies' and fills' intervals, over the units traced."""
    if ctx.trace is None or not ctx.trace["busy_us"]:
        return None
    return ctx.trace["busy_us"] / 1000.0 / ctx.trace_units
