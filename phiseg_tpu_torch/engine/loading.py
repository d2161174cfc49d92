"""Load a trained experiment from its log dir: the config snapshot and a
tagged checkpoint (port of phiseg_tpu/engine/loading.py).

Equivalent of the reference eval scripts' pattern: read the config out of
the model dir, rebuild the model and restore a tagged checkpoint
(phiseg_test_quantitative.py:84-99, phiseg/phiseg_model.py:505-525).
The log dir may be the port's or phiseg_tpu's: both write the same
config.json, and the checkpoint is read in either format
(engine/checkpoint.py `load_tag`).
"""

from __future__ import annotations

import os

from phiseg_tpu_torch.engine.checkpoint import load_tag
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.train import create_train_state
from phiseg_tpu_torch.parallel.mesh import DeviceLike, resolve_device


def load_experiment(log_dir: str, tag: str = "latest", device: DeviceLike = "cuda"):
    """Returns (cfg, model, state, step) restored from log_dir, on the card
    unless the caller asks for the CPU (without a card, "cuda" raises)."""
    device = resolve_device(device)
    cfg_path = os.path.join(log_dir, "config.json")
    if not os.path.exists(cfg_path):
        raise FileNotFoundError(
            f"no config.json snapshot in {log_dir} -- was this dir created by "
            "phiseg_tpu_torch.cli.train or phiseg_tpu's trainer?")
    cfg = ExperimentConfig.load(cfg_path)
    state = create_train_state(cfg, device)
    state, step = load_tag(state, log_dir, tag)
    return cfg, state.model, state, step
