"""The PHiSeg model: components, family modules, SegVAE (phiseg_tpu.models'
names) and the HPU-Net's subclass of it, HPUNet."""

from phiseg_tpu_torch.models.components import (
    EncoderTower,
    GaussianHead,
    LatentHierarchy,
    UNetCore,
    default_channels,
)
from phiseg_tpu_torch.models.hpunet import HPUNet
from phiseg_tpu_torch.models.segvae import ModelOutputs, SegVAE, aggregate_levels


def model_class(model_family: str) -> type:
    """The class that builds a model family: HPUNet for "hpu_net", else
    SegVAE, whose constructor refuses a name it does not know."""
    return HPUNet if model_family == "hpu_net" else SegVAE


# phiseg_tpu.models' names; HPUNet and model_class are the port's own
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
