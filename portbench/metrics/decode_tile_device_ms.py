"""decode_tile_device_ms.<cell>: device ms an image between the CUDA events at
the edges of the span `sample.decode.tile` in the traced window: the tiling of
the sampler's cache to S x B rows (engine/train.py _decode_draws; for the
HPU-Net every level of the prior's encoder features). Nothing where the
program has no such span (a commit before it)."""

from portbench.spans import device_ms_per_image


def read(ctx):
    return device_ms_per_image(ctx, "sample.decode.tile")
