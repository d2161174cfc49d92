"""Activation functions (port of phiseg_tpu/nn/activations.py; ref
tfwrapper/activations.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def leaky_relu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    """max(x, alpha*x) (ref activations.py:3-4)."""
    return torch.maximum(x, alpha * x)


relu = F.relu
softplus = F.softplus


def identity(x: torch.Tensor) -> torch.Tensor:
    """x unchanged (ref normalisation.identity / tf.identity)."""
    return x
