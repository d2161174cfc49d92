"""device_idle_pct.<kind>: 100 x (1 - the trace's device-busy ms per unit
over the untraced window's wall ms per unit). Nothing without a trace."""

from portbench.readers import device_ms_per_unit, wall_ms_per_unit


def read(ctx):
    d = device_ms_per_unit(ctx)
    return None if d is None else 100.0 * (1.0 - d / wall_ms_per_unit(ctx))
