"""The port's config and experiment registry vs phiseg_tpu's: the same fields,
the same registered experiments, and config.json round trips both ways."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from phiseg_tpu.engine.config import ExperimentConfig as JaxConfig
from phiseg_tpu.experiments import get_experiment as jax_get, list_experiments as jax_list
from phiseg_tpu_torch.data import get_dataset
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.experiments import get_experiment, list_experiments

torch.set_num_threads(1)


def test_same_fields_and_defaults():
    assert dataclasses.asdict(ExperimentConfig()) == dataclasses.asdict(JaxConfig())


def test_registry_matches_jax_registry():
    """Every JAX experiment is in the port with equal fields; the port's only
    names beyond them are the HPU-Net's and SSN's, families the JAX package
    lacks."""
    assert set(list_experiments()) - set(jax_list()) == {"hpunet", "hpunet_synth", "ssn",
                                                         "ssn_synth"}
    assert set(jax_list()) <= set(list_experiments())
    for name in jax_list():
        assert dataclasses.asdict(get_experiment(name)) == dataclasses.asdict(jax_get(name)), name


@pytest.mark.parametrize("name", ["phiseg_7_5", "phiseg_7_5_synth", "probunet_bf", "detunet_ms"])
def test_jax_config_json_loads_into_the_port_and_back(name):
    jcfg = jax_get(name).replace(lr_schedule={0: 1e-3, 1000: 1e-4}, resize_to=(64, 64))
    cfg = ExperimentConfig.from_json(jcfg.to_json())
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.to_json() == jcfg.to_json()
    assert JaxConfig.from_json(cfg.to_json()) == jcfg


def test_dtype_is_a_torch_dtype():
    assert ExperimentConfig().dtype is torch.bfloat16
    assert ExperimentConfig(compute_dtype="float32").dtype is torch.float32
    assert JaxConfig().dtype == jnp.bfloat16


def test_dataset_registry_synthetic_and_unported_lidc(tmp_path, monkeypatch):
    """Synthetic data loads; LIDC is ported (tests/test_torch_lidc.py) and
    reads PHISEG_DATA_ROOT, so a missing pickle raises; the datasets that the
    reference names but never shipped still raise NotImplementedError."""
    cfg = get_experiment("phiseg_7_5_synth").replace(image_size=(32, 32, 1), synth_n_train=6,
                                                     synth_n_val=2, synth_n_test=2)
    data = get_dataset(cfg)
    x, s = data.train.next_batch(4)
    assert x.shape == (4, 32, 32, 1) and s.shape == (4, 32, 32)
    monkeypatch.setenv("PHISEG_DATA_ROOT", str(tmp_path / "missing.pickle"))
    monkeypatch.setenv("PHISEG_PREPROC_ROOT", str(tmp_path / "preproc"))
    with pytest.raises(FileNotFoundError):
        get_dataset(get_experiment("phiseg_7_5"))
    for name in ("acdc", "uzh_prostate"):
        with pytest.raises(NotImplementedError, match="no loader was shipped"):
            get_dataset(cfg.replace(data_identifier=name))
