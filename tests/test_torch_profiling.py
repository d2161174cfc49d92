"""The port's profiling hooks (utils/profiling.py) on the CPU: the
environment parsed as the JAX package parses it, a StepProfiler session that
covers exactly its window of steps and writes one Chrome trace for it, the
Trainer's hook around its steps, and the spans: nothing with no profiler
running, records on the trace's clock under one, the train step's phases,
the prefetch thread's CPU clock and the eval's two stages."""

import contextlib
import json
import os
import threading
import time

import numpy as np
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

    # a window that ends at a validation step holds the validation and its
    # checkpoint stall: the window closes after the step's loop body
    monkeypatch.setenv("PHISEG_PROFILE_STEPS", "1:2")
    cfg = cfg.replace(validation_frequency=2)
    trainer = Trainer(cfg, log_dir=str(tmp_path / "log3"), device="cpu")
    trainer.train(get_dataset(cfg), num_iter=4)
    (path,) = trainer.profiler.traces
    with open(path) as f:
        annotations = [e["name"] for e in json.load(f)["traceEvents"]
                       if e.get("cat") == "user_annotation"]
    for name in ("validation", "checkpoint.snapshot", "validation.sample"):
        assert annotations.count(name) == 1, name
    assert annotations.count("train_step") == 2
    recs = tprof.SPANS.records()
    assert [r.unit for r in recs if r.name == "train_step"] == [1, 2]
    (snap,) = [r for r in recs if r.name == "checkpoint.snapshot"]
    assert snap.unit == 2 and snap.parent.name == "validation"


@pytest.fixture
def span_log(monkeypatch):
    """A fresh span log in place of the process's."""
    log = tprof.SpanLog()
    monkeypatch.setattr(tprof, "SPANS", log)
    return log


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _tiny_cfg():
    from phiseg_tpu_torch.experiments import get_experiment

    return get_experiment("phiseg_7_5_synth").replace(
        latent_levels=2, resolution_levels=3, n0=2, zdim0=2, image_size=(16, 16, 1),
        batch_size=2, compute_dtype="float32")


def test_span_without_a_profiler_does_nothing(span_log, monkeypatch):
    """With no profiler running a span is the shared no-op: it never calls
    record_function, reads no clock and records nothing."""
    def boom(*a, **k):
        raise AssertionError("called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(tprof.time, "time_ns", boom)
    monkeypatch.setattr(tprof.time, "thread_time_ns", boom)
    for _ in range(3):
        with tprof.span("a", unit=1, device="cpu") as rec:
            with tprof.span("a.b"):
                assert rec is None
    assert tprof.span("x") is tprof.span("y", 2)
    assert span_log.records() == [] and not span_log.live


def test_nested_spans_on_the_trace_clock(span_log, tmp_path):
    """Under a profiler, nested spans give names, parents and units (a
    child takes its parent's), and each record after the session's first
    starts where its user_annotation does on the trace's clock, within
    50 us. (The profiler's set-up of a session's first event, after its
    own time stamp, makes the first span's later by up to ~0.1 ms.)"""
    with _cpu_profile() as prof:
        with tprof.span("first", unit=0):
            pass
        with tprof.span("outer", unit=7) as outer:
            with tprof.span("outer.inner") as inner:
                torch.ones(4).add_(1.0)
            with tprof.span("outer.other", unit=99):
                pass
        with tprof.span("second", unit=8):
            pass
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    first, *recs = span_log.records()
    assert first.name == "first" and first.parent is None and first.unit == 0
    assert [r.name for r in recs] == ["outer", "outer.inner", "outer.other", "second"]
    assert [r.parent.name if r.parent else None for r in recs] == [None, "outer", "outer", None]
    assert [r.unit for r in recs] == [7, 7, 7, 8]
    assert recs[0] is outer and recs[1] is inner
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert all(r.events is None and 0 <= r.cpu_ns for r in recs)
    assert all(r.thread == threading.get_ident() for r in recs)
    with open(path) as f:
        trace = json.load(f)
    base_us = trace["baseTimeNanoseconds"] / 1000
    starts = {e["name"]: e["ts"] + base_us for e in trace["traceEvents"]
              if e.get("cat") == "user_annotation"}
    for r in recs:
        assert abs(r.start_ns / 1000 - starts[r.name]) < 50, r.name


def test_span_log_lifetime(span_log):
    """The first span under a profiler clears the last session's log; the
    first on that thread without one ends the session and keeps its
    records; meanwhile a thread started before the session (which the
    profiler cannot see) records while the log is live, and not after."""
    seen = {}
    go, done = threading.Event(), threading.Event()

    def other():
        go.wait(5)
        with tprof.span("other") as rec:
            seen["rec"] = rec
        done.set()

    t = threading.Thread(target=other)
    t.start()
    for session in range(2):
        with _cpu_profile():
            with tprof.span(f"s{session}"):
                pass
            if session == 0:
                go.set()
                assert done.wait(5)
        assert span_log.live
        with tprof.span("after") as rec:
            assert rec is None
        assert not span_log.live
        names = [r.name for r in span_log.records()]
        assert names == (["s0", "other"] if session == 0 else ["s1"])
    t.join(5)
    assert not t.is_alive() and seen["rec"].name == "other"
    assert seen["rec"].thread != threading.get_ident() and seen["rec"].parent is None


def test_profile_session_stop_ends_the_log(span_log, tmp_path):
    session = tprof.ProfileSession(str(tmp_path), "s", "cpu")
    with tprof.span("in") as rec:
        assert rec is not None
    session.stop()
    assert not span_log.live and [r.name for r in span_log.records()] == ["in"]
    rows = tprof.summarize_spans(span_log.records())
    assert [(n, c, d) for n, c, _, d in rows] == [("in", 1, None)]


def test_train_step_spans_change_no_number(span_log):
    """A tiny train step with and without a profiler gives bitwise the same
    losses and parameters; under the profiler each step has one span of
    each phase, inside its `train_step`."""
    from phiseg_tpu_torch.data.augment_device import make_augment_fn
    from phiseg_tpu_torch.engine.train import create_train_state, make_train_step

    cfg = _tiny_cfg()
    step = make_train_step(cfg, make_augment_fn(cfg.augmentation_options, cfg.nlabels))
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 16, 16, 1).astype(np.float32))
    s = torch.from_numpy(np.random.RandomState(1).randint(0, 2, (2, 16, 16)))

    def run(traced):
        state = create_train_state(cfg, device="cpu", seed=3)
        gen = torch.Generator().manual_seed(4)
        with _cpu_profile() if traced else contextlib.nullcontext():
            losses = [step(state, x, s, gen) for _ in range(2)]
        return losses, dict(state.model.named_parameters())

    plain, traced = run(False), run(True)
    for a, b in zip(plain[0], traced[0]):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(plain[1][n], traced[1][n]) for n in plain[1])
    recs = span_log.records()
    steps = [r for r in recs if r.name == "train_step"]
    assert [r.unit for r in steps] == [0, 1]
    phases = ("train_step.augment", "train_step.forward", "train_step.backward",
              "train_step.optimizer")
    for parent in steps:
        kids = [r for r in recs if r.parent is parent]
        assert tuple(r.name for r in kids) == phases
        assert all(parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns for r in kids)
        assert all(r.unit == parent.unit for r in kids)


def test_prefetch_wait_reads_the_producers_cpu_clock(span_log):
    """`data.wait` stores the prefetch thread's CPU clock, which never goes
    down, though the thread started before the session and the profiler
    cannot see it."""
    from phiseg_tpu_torch.engine.trainer import _Prefetcher

    class Busy:
        def next_batch(self, n):
            t0 = time.thread_time()
            a = np.ones((64, 64))
            while time.thread_time() - t0 < 0.003:
                a = a @ a / 64.0
            return np.zeros((n, 4, 4), np.float32), np.zeros((n, 4, 4), np.uint8)

    pre = _Prefetcher(Busy(), 2)
    try:
        time.sleep(0.05)
        with _cpu_profile():
            for _ in range(6):
                pre.next()
    finally:
        pre.stop()
    waits = span_log.records()
    assert [r.name for r in waits] == ["data.wait"] * 6
    values = [r.value for r in waits]
    assert all(v is not None for v in values)
    assert all(b >= a for a, b in zip(values, values[1:])) and values[-1] > values[0]
    assert pre._producer_cpu_ns() is None  # the thread has ended


def test_quant_eval_spans_each_call(span_log):
    """make_quant_eval_fn records `eval.sample` (with the sampler's spans
    inside) and `eval.metrics` once a call, its unit the call's count; on
    the CPU no span has device events."""
    from phiseg_tpu_torch.engine.train import build_model
    from phiseg_tpu_torch.engine.validation import make_quant_eval_fn

    cfg = _tiny_cfg()
    quant = make_quant_eval_fn(build_model(cfg, "cpu", seed=0), cfg, 3)
    x = torch.randn(2, 16, 16, 1)
    ann = torch.randint(0, 2, (2, 3, 16, 16))
    quant(x, ann, torch.Generator().manual_seed(0))  # call 0, untraced
    with _cpu_profile():
        for _ in range(2):
            quant(x, ann, torch.Generator().manual_seed(0))
    recs = span_log.records()
    top = [(r.name, r.unit) for r in recs if r.parent is None]
    assert top == [("eval.sample", 1), ("eval.metrics", 1), ("eval.sample", 2),
                   ("eval.metrics", 2)]
    inner = [(r.name, r.parent.name, r.unit) for r in recs if r.parent is not None]
    assert inner == [(n, "eval.sample", u) for u in (1, 2)
                     for n in ("sample.encode", "sample.decode", "sample.softmax")]
    assert all(r.events is None and r.device_ms() is None for r in recs)
