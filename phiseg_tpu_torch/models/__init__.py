"""The PHiSeg model: components, family modules, SegVAE (phiseg_tpu.models'
names) and its subclasses for the families the JAX package lacks: HPUNet,
the Hierarchical Probabilistic U-Net, and SSN, Stochastic Segmentation
Networks."""

from phiseg_tpu_torch.models.components import (
    EncoderTower,
    GaussianHead,
    LatentHierarchy,
    UNetCore,
    default_channels,
)
from phiseg_tpu_torch.models.hpunet import HPUNet
from phiseg_tpu_torch.models.segvae import ModelOutputs, SegVAE, aggregate_levels
from phiseg_tpu_torch.models.ssn import SSN

_SUBCLASSES = {"hpu_net": HPUNet, "ssn": SSN}


def model_class(model_family: str) -> type:
    """The class that builds a model family: HPUNet for "hpu_net", SSN for
    "ssn", else SegVAE (PHiSeg, the Probabilistic U-Net and the
    deterministic U-Net), whose constructor refuses a name it does not know."""
    return _SUBCLASSES.get(model_family, SegVAE)


# phiseg_tpu.models' names; HPUNet, SSN and model_class are the port's own
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
