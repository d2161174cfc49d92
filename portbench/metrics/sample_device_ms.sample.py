"""sample_device_ms.sample: device-busy ms per sampler call in the trace."""

from portbench.readers import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx)
