"""kernels_per_step.train: device kernels per train step in the trace."""


def read(ctx):
    if ctx.trace is None or not ctx.trace["kernels"]:
        return None
    return ctx.trace["kernels"] / ctx.trace_units
