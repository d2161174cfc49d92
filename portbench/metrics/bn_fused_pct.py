"""bn_fused_pct.<kind>: the share of the trace's eval-mode batch-norm
launches that ran fused with the activation and the cast, in %: 100 x the
launches of kernels named bn_act_eval over those plus the launches of
eval-BN kernels that are not it (cuDNN's bn_fw_inf, PyTorch's
batch_norm_transform_input). Nothing when the trace holds neither."""

from portbench.tracefile import op_time_us

FUSED = "bn_act_eval"
UNFUSED = ("bn_fw_inf", "batch_norm_transform_input")


def read(ctx):
    if ctx.trace is None:
        return None
    fused = op_time_us(ctx.trace, FUSED)[1]
    unfused = sum(op_time_us(ctx.trace, name)[1] for name in UNFUSED)
    if fused + unfused == 0:
        return None
    return 100.0 * fused / (fused + unfused)
