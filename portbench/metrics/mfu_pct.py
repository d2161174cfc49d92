"""mfu_pct.<kind>: the whole unit's share of the card's peak in the compute
dtype: the reference's FLOPs per unit (torch.utils.flop_counter on meta
tensors) times the untraced window's units, over its wall seconds, in %.
Nothing on a card without a peak in peaks.py."""

from portbench import peaks


def read(ctx):
    peak = peaks.peak_flops(ctx.device_name, ctx.cfg["compute_dtype"])
    if peak is None:
        return None
    return 100.0 * ctx.flops_per_unit() * ctx.units / ctx.seconds / peak
