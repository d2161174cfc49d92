"""Core NN op library of the port (phiseg_tpu/nn's exports, NCHW)."""

from phiseg_tpu_torch.nn.layers import (
    ConvBlock,
    Dense,
    avg_pool_2x2,
    max_pool_2x2,
    global_avg_pool,
    upsample_bilinear,
    upsample_nearest,
    resize_nearest,
    resize_bilinear,
)
from phiseg_tpu_torch.nn import losses

__all__ = [
    "ConvBlock",
    "Dense",
    "avg_pool_2x2",
    "max_pool_2x2",
    "global_avg_pool",
    "upsample_bilinear",
    "upsample_nearest",
    "resize_nearest",
    "resize_bilinear",
    "losses",
]
