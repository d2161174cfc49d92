"""Data layer: synthetic and LIDC datasets, batch provider, on-device and host augmentation."""

from phiseg_tpu_torch.data.batch_provider import BatchProvider
from phiseg_tpu_torch.data.registry import get_dataset

__all__ = ["BatchProvider", "get_dataset"]
