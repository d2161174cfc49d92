"""step_device_ms.train: device-busy ms per train step in the trace."""

from portbench.readers import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx)
