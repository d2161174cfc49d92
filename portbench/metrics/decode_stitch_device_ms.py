"""decode_stitch_device_ms.<cell>: device ms an image between the CUDA events at
the edges of the span `sample.decode.stitch` in the traced window: the
HPU-Net's stitching decoder and its logits over the tiled rows (levels 5-7,
32x32 to 128x128). Nothing where the program has no such span (a commit before
it)."""

from portbench.spans import device_ms_per_image


def read(ctx):
    return device_ms_per_image(ctx, "sample.decode.stitch")
