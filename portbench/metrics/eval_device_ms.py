"""eval_device_ms.<cell>: device-busy ms per image in the trace (encode,
the decode of every draw, softmax, GED^2 and S_NCC)."""

from portbench.readers import device_ms_per_unit


def read(ctx):
    d = device_ms_per_unit(ctx)
    return None if d is None else d / ctx.batch
