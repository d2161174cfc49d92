"""train_img_per_s: images completed over all of the window's wall seconds."""

from portbench.readers import images_per_s


def read(ctx):
    return images_per_s(ctx)
