"""Typed experiment configuration (PyTorch port of phiseg_tpu/engine/config.py).

The same frozen dataclass, field for field, so a `config.json` written by the
JAX package loads here unchanged and vice versa. Only `dtype` differs: it
returns a torch dtype.

Replaces the reference's Python-module-as-config system
(phiseg/experiments/*.py loaded via SourceFileLoader, phiseg_train.py:39-47).
Configs are frozen dataclasses registered by name
(phiseg_tpu/experiments/__init__.py); the "copy the config into the log dir
for provenance, evals reload the snapshot" contract is preserved by
serialising to JSON (ExperimentConfig.save/load below).

Machine-level paths come from environment variables, as in the JAX package:
  PHISEG_LOG_ROOT      -- experiment log root        (default ./logs)
  PHISEG_DATA_ROOT     -- raw LIDC pickle path
  PHISEG_PREPROC_ROOT  -- preprocessed HDF5 folder   (default ./preproc)
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch


def log_root() -> str:
    return os.environ.get("PHISEG_LOG_ROOT", os.path.join(os.getcwd(), "logs"))


def data_root() -> str:
    return os.environ.get("PHISEG_DATA_ROOT", "")


def preproc_root() -> str:
    return os.environ.get("PHISEG_PREPROC_ROOT", os.path.join(os.getcwd(), "preproc"))


# The fields that fix what a checkpoint holds: the model's parameters and
# buffers and the optimiser's state. A run resumes a log dir only with the
# values its config.json holds for them (engine/trainer.py).
CHECKPOINT_FIELDS = ("model_family", "latent_levels", "resolution_levels", "n0", "zdim0",
                     "norm", "image_size", "nlabels", "optimizer")


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """All hyperparameters of one experiment (ref phiseg/experiments/phiseg_7_5.py)."""

    experiment_name: str = "phiseg_7_5"
    log_dir_name: str = "lidc"

    # -- architecture (ref phiseg_7_5.py:8-19)
    model_family: str = "phiseg"  # phiseg | prob_unet | det_unet | hpu_net | ssn
    latent_levels: int = 5
    resolution_levels: int = 7
    n0: int = 32
    zdim0: int = 2
    norm: str = "batch"
    compute_dtype: str = "bfloat16"  # conv/matmul path dtype; params stay f32

    # -- data (ref phiseg_7_5.py:22-34)
    data_identifier: str = "lidc"  # lidc | synthetic
    image_size: Tuple[int, int, int] = (128, 128, 1)
    nlabels: int = 2
    num_labels_per_subject: int = 4
    annotator_range: Tuple[int, ...] = (0, 1, 2, 3)
    # Provider-side nearest-neighbour resize to (H, W) before augmentation
    # (ref batch_provider.py:35,101-103); None = off, like all LIDC configs.
    resize_to: Optional[Tuple[int, int]] = None
    augmentation_options: Mapping[str, Any] = dataclasses.field(
        default_factory=lambda: {
            "do_fliplr": True,
            "do_flipud": True,
            "do_rotations": True,
            "do_scaleaug": True,
            "augment_every_nth": 2,
        }
    )
    # On-device augmentation inside the jitted train step (TPU-first; the
    # reference augments per-image with cv2 on the host, batch_provider.py:140).
    augment_on_device: bool = True

    # -- training (ref phiseg_7_5.py:37-42)
    optimizer: str = "adam"
    lr_schedule: Mapping[int, float] = dataclasses.field(
        default_factory=lambda: {0: 1e-3}
    )
    batch_size: int = 12
    num_iter: int = 5_000_000

    # -- losses (ref phiseg_7_5.py:45-48)
    kl_divergence_loss_weight: Optional[float] = 1.0
    exponential_weighting: bool = True
    residual_multinoulli_loss_weight: Optional[float] = 1.0
    weight_decay_weight: Optional[float] = None

    # -- monitoring (ref phiseg_7_5.py:51-56)
    do_image_summaries: bool = True
    # Weight/activation histograms + per-level diagnostics each validation
    # (ref auto-attaches tf.summary.histogram per layer, layers.py:671-677).
    do_histogram_summaries: bool = True
    validation_frequency: int = 500
    validation_samples: int = 16
    # Posterior draws per image for the validation ELBO; the reference tiles
    # each image x16 and evaluates loss_tot over the tiled batch (:577-585).
    validation_elbo_samples: int = 16
    num_validation_images: int = 100
    tensorboard_update_frequency: int = 100

    # -- framework extras (no reference equivalent)
    # None = auto: the fused residual-CE CUDA kernel when the tensors are on
    # a CUDA device, its plain PyTorch version on the CPU. True/False forces.
    use_fused_loss_kernel: Optional[bool] = None
    seed: int = 42
    checkpoint_keep: int = 2
    # Unpruned time-based archive saves (ref keep_checkpoint_every_n_hours=3,
    # phiseg_model.py:144). None disables.
    archive_every_hours: Optional[float] = 3.0
    mesh_data_axis: Optional[int] = None  # None -> all local devices
    # Documented deviation (README): clamp sigmas to >= this inside the KL
    # only. None = reference-faithful +1e-10 guards (phiseg_model.py:210-226),
    # which spike the loss to ~1e11 when a softplus-sigma saturates near 0.
    kl_sigma_floor: Optional[float] = None
    # Documented deviation (README): persist best-metric values alongside
    # checkpoints so a resumed run cannot clobber a better historical best_*
    # tag (the reference resets its best values on every train() start,
    # phiseg_model.py:180-184). False restores reference behaviour.
    persist_best_metrics: bool = True
    # Serialise + write checkpoints on a background thread so the hot loop
    # is not blocked by ~seconds of msgpack+disk per validation (the
    # reference's saver.save blocks the session loop, phiseg_model.py:534).
    async_checkpointing: bool = True
    # Synthetic-dataset shape (data_identifier="synthetic"): split sizes and
    # task generator ("nested" = single nested-threshold lesion;
    # "multiscale" = several lesions at different scales with per-lesion
    # independent annotator disagreement -- see data/synthetic.py).
    synth_task: str = "nested"
    synth_n_train: int = 128
    synth_n_val: int = 32
    synth_n_test: int = 32

    # ------------------------------------------------------------------

    @property
    def image_hw(self) -> Tuple[int, int]:
        return (self.image_size[0], self.image_size[1])

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def effective_latent_levels(self) -> int:
        """The latent levels the model has: latent_levels for PHiSeg and the
        HPU-Net, 1 for the (probabilistic) U-Nets, 2 for SSN (its sampler's
        two noises, one a logit and one of the rank zdim0)."""
        if self.model_family == "ssn":
            return 2
        return self.latent_levels if self.model_family in ("phiseg", "hpu_net") else 1

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    # -- provenance snapshot (ref phiseg_train.py:44-47) -------------------

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["lr_schedule"] = {str(k): v for k, v in self.lr_schedule.items()}
        d["augmentation_options"] = dict(self.augmentation_options)
        return json.dumps(d, indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        d: Dict[str, Any] = json.loads(text)
        d["lr_schedule"] = {int(k): float(v) for k, v in d["lr_schedule"].items()}
        d["image_size"] = tuple(d["image_size"])
        d["annotator_range"] = tuple(d["annotator_range"])
        if d.get("resize_to") is not None:
            d["resize_to"] = tuple(d["resize_to"])
        return cls(**d)

    def save(self, path: str) -> None:
        """Write to_json() to `path`, published atomically (tmp + os.replace):
        a reader never sees half a file."""
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.to_json())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_json(f.read())
