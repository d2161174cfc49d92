"""sample_encode_device_ms.<cell>: device ms an image between the CUDA events
at the edges of the sampler's span `sample.encode` in the traced window: the
x-only part of sampling, once a batch (for SSN the U-Net and its three heads
at B rows). Nothing where the program has no such span."""

from portbench.spans import device_ms_per_image


def read(ctx):
    return device_ms_per_image(ctx, "sample.encode")
