"""frce_roofline.train: the fused residual cross-entropy kernels' least time
(their bytes over the card's HBM rate; K1 and K2 are bound by bytes) over
their device time in the trace (kernels named frce_fwd_kernel and
frce_bwd_kernel), in %. Nothing when the trace holds neither."""

from portbench import peaks
from portbench.counts import frce_bytes
from portbench.tracefile import op_time_us


def read(ctx):
    if ctx.trace is None:
        return None
    fwd_us, fwd_n = op_time_us(ctx.trace, "frce_fwd_kernel")
    bwd_us, bwd_n = op_time_us(ctx.trace, "frce_bwd_kernel")
    rate = peaks.peak_bytes_s(ctx.device_name)
    if not (fwd_n and bwd_n) or rate is None:
        return None
    k1, k2 = frce_bytes(ctx.cfg, ctx.batch)
    least_us = 1e6 * (fwd_n * k1 + bwd_n * k2) / rate
    return 100.0 * least_us / (fwd_us + bwd_us)
