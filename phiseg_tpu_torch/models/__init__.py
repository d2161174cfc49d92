"""The PHiSeg model: components, family modules and SegVAE (phiseg_tpu.models'
names)."""

from phiseg_tpu_torch.models.components import (
    EncoderTower,
    GaussianHead,
    LatentHierarchy,
    UNetCore,
    default_channels,
)
from phiseg_tpu_torch.models.segvae import ModelOutputs, SegVAE, aggregate_levels

__all__ = [
    "EncoderTower",
    "GaussianHead",
    "LatentHierarchy",
    "UNetCore",
    "default_channels",
    "SegVAE",
    "ModelOutputs",
    "aggregate_levels",
]
