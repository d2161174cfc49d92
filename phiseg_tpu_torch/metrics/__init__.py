"""Uncertainty and accuracy metrics on tensors (port of phiseg_tpu/metrics)."""

from phiseg_tpu_torch.metrics.metrics import (
    dice_per_label,
    ged_terms,
    generalised_energy_distance,
    ncc,
    pairwise_iou_distance,
    population_std,
    variance_ncc_dist,
    variance_ncc_maps,
)

__all__ = [
    "dice_per_label",
    "ged_terms",
    "generalised_energy_distance",
    "ncc",
    "pairwise_iou_distance",
    "population_std",
    "variance_ncc_dist",
    "variance_ncc_maps",
]
