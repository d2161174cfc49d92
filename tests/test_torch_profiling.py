"""The port's profiling hooks (utils/profiling.py) on the CPU: the
environment parsed as the JAX package parses it, a StepProfiler session that
covers exactly its window of steps and writes one Chrome trace for it, and
the Trainer's hook around its steps."""

import json
import logging
import os

import pytest
import torch

from phiseg_tpu.utils import profiling as jprof
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.utils import profiling as tprof

torch.set_num_threads(1)


@pytest.mark.parametrize("env", [
    {},
    {"PHISEG_PROFILE_DIR": "/tmp/x"},
    {"PHISEG_PROFILE_DIR": "/tmp/x", "PHISEG_PROFILE_STEPS": "5:10"},
    {"PHISEG_PROFILE_STEPS": "5:10"},
])
def test_profile_config_parses_as_jax(env, monkeypatch):
    for k in ("PHISEG_PROFILE_DIR", "PHISEG_PROFILE_STEPS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tprof.profile_config() == jprof.profile_config()


def _ops(path, name):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "cpu_op" and e.get("name") == name]


def test_step_profiler_traces_only_its_window(tmp_path, monkeypatch):
    """Steps 2..4 of 0..6 are traced, both ends included, in one session
    with one trace file; an op of every traced step is in it and none of the
    others'."""
    monkeypatch.setenv("PHISEG_PROFILE_DIR", str(tmp_path))
    monkeypatch.setenv("PHISEG_PROFILE_STEPS", "2:4")
    prof = tprof.StepProfiler("cpu")
    a = torch.ones(8)
    for step in range(7):
        prof.maybe_start(step)
        assert prof.active == (2 <= step <= 4)
        for _ in range(step + 1):  # step k runs k + 1 additions
            a = torch.add(a, 1.0)
        prof.maybe_stop(step)
    prof.close()  # nothing open: no second trace
    assert len(prof.traces) == 1 and os.listdir(tmp_path) == [os.path.basename(prof.traces[0])]
    assert os.path.basename(prof.traces[0]).startswith("steps2-4.")
    assert len(_ops(prof.traces[0], "aten::add")) == 3 + 4 + 5


def test_step_profiler_without_dir_does_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("PHISEG_PROFILE_DIR", raising=False)
    prof = tprof.StepProfiler("cpu")
    for step in range(4):
        prof.maybe_start(step)
        assert not prof.active
        prof.maybe_stop(step)
    assert prof.traces == []


def test_trace_if_enabled_and_timed_section(tmp_path, monkeypatch, caplog):
    monkeypatch.setenv("PHISEG_PROFILE_DIR", str(tmp_path))
    with tprof.trace_if_enabled("cpu", label="block"):
        torch.mul(torch.ones(4), 2.0)
    (name,) = os.listdir(tmp_path)
    assert name.startswith("block.") and _ops(os.path.join(tmp_path, name), "aten::mul")
    monkeypatch.delenv("PHISEG_PROFILE_DIR")
    with tprof.trace_if_enabled("cpu", label="off"):
        pass
    assert os.listdir(tmp_path) == [name]
    with caplog.at_level(logging.INFO):
        with tprof.timed_section("validation"):
            pass
    assert "@ validation took:" in caplog.text


def test_trainer_hook_traces_its_window(tmp_path, monkeypatch):
    """Trainer.train calls the profiler around each step: a 4-step run with
    PHISEG_PROFILE_STEPS=1:2 writes one trace holding the optimiser steps of
    steps 1 and 2; a window that the run ends inside is closed at the end."""
    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.trainer import Trainer

    cfg = ExperimentConfig(experiment_name="prof", model_family="phiseg", latent_levels=2,
                           resolution_levels=3, n0=2, zdim0=2, image_size=(8, 8, 1),
                           compute_dtype="float32", norm="batch", batch_size=2,
                           data_identifier="synthetic", synth_n_train=4, synth_n_val=2,
                           synth_n_test=2, validation_frequency=100,
                           tensorboard_update_frequency=100, do_image_summaries=False,
                           do_histogram_summaries=False)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("PHISEG_PROFILE_DIR", str(trace_dir))
    monkeypatch.setenv("PHISEG_PROFILE_STEPS", "1:2")
    trainer = Trainer(cfg, log_dir=str(tmp_path / "log"), device="cpu")
    trainer.train(get_dataset(cfg), num_iter=4)
    (path,) = trainer.profiler.traces
    assert os.listdir(trace_dir) == [os.path.basename(path)]
    with open(path) as f:
        names = [e.get("name", "") for e in json.load(f)["traceEvents"]]
    assert sum(n.startswith("Optimizer.step#Adam.step") for n in names) == 2

    monkeypatch.setenv("PHISEG_PROFILE_STEPS", "5:9")
    trainer = Trainer(cfg, log_dir=str(tmp_path / "log2"), device="cpu")
    trainer.train(get_dataset(cfg), num_iter=7)
    assert len(trainer.profiler.traces) == 1 and not trainer.profiler.active
