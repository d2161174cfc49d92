"""Training engine: config, objective, train step and loop, validation,
checkpoints, loading and inference."""

from phiseg_tpu_torch.engine.config import ExperimentConfig

__all__ = ["ExperimentConfig"]
