"""eval_metrics_device_ms.<cell>: device ms an image between the CUDA events
at the edges of the eval's `eval.metrics` span (GED^2's terms and S_NCC of
the draws) in the traced window; the rest of eval_device_ms.<cell> is the
sampler's. The events time the stream between the two points, so idle
time inside the span, if any, counts too."""

from portbench.spans import device_ms_per_image


def read(ctx):
    return device_ms_per_image(ctx, "eval.metrics")
