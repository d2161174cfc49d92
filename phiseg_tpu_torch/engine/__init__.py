"""Training engine: config, objective, train step and loop, validation,
checkpoints, loading and inference. The package exports phiseg_tpu.engine's
names; importing it builds no kernel (the CUDA library is built at the first
launch, ops/fused_residual_ce.py)."""

from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.objective import phiseg_objective
from phiseg_tpu_torch.engine.train import (
    TrainState,
    build_model,
    create_train_state,
    make_eval_loss_fn,
    make_sample_fn,
    make_train_step,
)

__all__ = [
    "ExperimentConfig",
    "phiseg_objective",
    "TrainState",
    "build_model",
    "create_train_state",
    "make_train_step",
    "make_sample_fn",
    "make_eval_loss_fn",
]
