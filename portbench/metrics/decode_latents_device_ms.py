"""decode_latents_device_ms.<cell>: device ms an image between the CUDA events at
the edges of the span `sample.decode.latents` in the traced window: the
HPU-Net prior core's latent levels over the tiled rows (its four 1x1 heads,
draws, nearest x2 upsamples, concatenations and residual blocks up to 16x16).
Nothing where the program has no such span (a commit before it)."""

from portbench.spans import device_ms_per_image


def read(ctx):
    return device_ms_per_image(ctx, "sample.decode.latents")
