"""decode_lowrank_device_ms.<cell>: device ms an image between the CUDA events
at the edges of the span `sample.decode.lowrank` in the traced window: SSN's
draws of the logits, mu + W eps_W + sqrt(D) eps_D over the S x B rows from
the B-row (mu, W, D), no network. Nothing where the program has no such span
(a commit before it)."""

from portbench.spans import device_ms_per_image


def read(ctx):
    return device_ms_per_image(ctx, "sample.decode.lowrank")
