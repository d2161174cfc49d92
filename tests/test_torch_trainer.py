"""The port's Trainer end to end on the CPU: the loop with validation,
checkpoints and resume, the validation scalars and diagnostics, best-metric
persistence, the async writer, and a 2-rank gloo run through the CLI (the
cases of tests/test_trainer.py that apply to the port, plus: the scalar key
names of one validation equal the JAX trainer's, and N steps + save + resume
+ M steps equal N + M unbroken steps bitwise, and the ranks of a mesh train
on the same global batches across validations)."""

import glob
import json
import math
import os

import numpy as np
import pytest
import torch

from phiseg_tpu_torch.cli.train import main as cli_main
from phiseg_tpu_torch.data import get_dataset
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.trainer import Trainer
from phiseg_tpu_torch.parallel import make_mesh, spawn_ranks
from test_tb_writer import _parse_proto_fields, _read_records

torch.set_num_threads(1)
BASE = dict(experiment_name="trainer_test", model_family="phiseg", latent_levels=2,
            resolution_levels=4, n0=2, zdim0=2, image_size=(16, 16, 1),
            compute_dtype="float32", norm="none", data_identifier="synthetic", batch_size=4,
            validation_frequency=10, tensorboard_update_frequency=5, num_validation_images=4,
            validation_samples=3, validation_elbo_samples=2, augment_on_device=False)


@pytest.fixture
def cfg(tmp_path, monkeypatch):
    monkeypatch.setenv("PHISEG_LOG_ROOT", str(tmp_path))
    return ExperimentConfig(**BASE)


def _data(cfg):
    return get_dataset(cfg, n_train=16, n_val=4, n_test=4)


def _tags(path):
    """(histogram, image, scalar) tag sets of an event file."""
    hist, img, scalar = set(), set(), set()
    for rec in _read_records(path):
        ev = _parse_proto_fields(rec)
        if 5 not in ev:
            continue
        for raw in _parse_proto_fields(ev[5][0]).get(1, []):
            val = _parse_proto_fields(raw)
            tag = val[1][0].decode()
            (hist if 5 in val else img if 4 in val else scalar).add(tag)
    return hist, img, scalar


def test_trainer_end_to_end_and_resume(cfg):
    data = _data(cfg)
    trainer = Trainer(cfg, device="cpu")
    log_dir = trainer.log_dir
    trainer.train(data, num_iter=21)
    assert os.path.exists(os.path.join(log_dir, "config.json"))
    lines = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    assert [r["step"] for r in lines if "validation_GED" in r] == [10, 20]
    assert any("batch_total_loss" in r for r in lines)
    evs = glob.glob(os.path.join(log_dir, "events.out.tfevents.*"))
    assert evs and os.path.getsize(evs[0]) > 100
    for tag in ("latest", "best_dice", "best_ged", "best_ncc", "best_loss"):
        assert trainer.ckpt.has_checkpoint(tag), tag
    last_step = trainer.ckpt.latest_step("latest")
    assert last_step == 21 == trainer.state.step

    trainer2 = Trainer(cfg, device="cpu")  # resumes where the first left off
    assert trainer2.init_step == last_step
    trainer2.train(data, num_iter=last_step + 5)
    assert trainer2.state.step == last_step + 5
    assert trainer2.ckpt.latest_step("latest") == last_step + 5


def test_trainer_validation_metrics_sane(cfg):
    scalars = Trainer(cfg, device="cpu").do_validation(_data(cfg), step=0)
    assert 0.0 <= scalars["validation_dice_mean_score"] <= 1.0
    assert np.isfinite(scalars["validation_GED"])
    assert -1.0 <= scalars["validation_NCC"] <= 1.0
    assert np.isfinite(scalars["validation_neg_elbo"])


def test_validation_scalar_keys_equal_the_jax_trainers(cfg, tmp_path):
    """One validation writes the same scalar names in both trainers
    (histograms off on both sides to keep the JAX compile short)."""
    from phiseg_tpu.data import get_dataset as jax_get_dataset
    from phiseg_tpu.engine.config import ExperimentConfig as JaxConfig
    from phiseg_tpu.engine.trainer import Trainer as JaxTrainer

    kw = dict(BASE, do_histogram_summaries=False)
    jcfg = JaxConfig(**kw)
    want = JaxTrainer(jcfg, log_dir=str(tmp_path / "jax")).do_validation(
        jax_get_dataset(jcfg, n_train=16, n_val=4, n_test=4), step=0)
    pcfg = ExperimentConfig(**kw)
    got = Trainer(pcfg, log_dir=str(tmp_path / "port"), device="cpu").do_validation(
        _data(pcfg), step=0)
    assert sorted(got) == sorted(want)
    assert "learning_rate" not in got  # a train-loop-only scalar


def test_trainer_validation_diagnostics_written(cfg):
    """Validation writes the reference's monitoring surface: per-level
    mu/sigma scalars (ref :719-726), per-level output grids (:728-736),
    weight/activation histograms (layers.py:671-677), a kernel grid."""
    trainer = Trainer(cfg, device="cpu")
    scalars = trainer.do_validation(_data(cfg), step=0)
    for i in range(cfg.latent_levels):
        assert f"average_mu_lvl{i}" in scalars
        assert f"average_prior_sigma_lvl{i}" in scalars
    trainer.writer.flush()
    hist, img, scalar = _tags(trainer.writer.path)
    assert any(t.startswith("weights/") and t.endswith("conv.weight") for t in hist)
    assert any(t.startswith("activations/") for t in hist)
    for i in range(cfg.latent_levels):
        assert {f"val_s_out_list_{i}", f"val_s_accum_list_{i}", f"train_s_out_list_{i}"} <= img
    for t in ("train_x_inp", "train_s_inp", "val_x_inp", "val_s_inp", "val_s_out",
              "train_s_out", "generated_seg", "generated_x_in"):
        assert t in img, t
    assert any(t.startswith("kernels/") for t in img)
    assert "average_mu_lvl0" in scalar


def test_trainer_histograms_can_be_disabled(cfg):
    trainer = Trainer(cfg.replace(do_histogram_summaries=False, experiment_name="nohist"),
                      device="cpu")
    trainer.do_validation(_data(cfg), step=0)
    trainer.writer.flush()
    hist, img, _ = _tags(trainer.writer.path)
    assert not hist and img


def test_no_resume_through_the_cli(cfg, tmp_path):
    path = str(tmp_path / "cfg.json")
    cfg.replace(synth_n_train=16, synth_n_val=4, synth_n_test=4).save(path)
    log_dir = str(tmp_path / "log")
    t1 = cli_main([path, "--num-iter", "11", "--log-dir", log_dir, "--device", "cpu"])
    assert t1.state.step == 11
    t2 = cli_main([path, "--num-iter", "12", "--log-dir", log_dir, "--device", "cpu"])
    assert t2.init_step == 11 and t2.state.step == 12
    t3 = cli_main([path, "--num-iter", "2", "--log-dir", log_dir, "--device", "cpu",
                   "--no-resume"])
    assert t3.init_step == 0 and t3.state.step == 2


def test_best_metrics_persist_across_resume(cfg):
    """A resumed run does not clobber a better historical best_* checkpoint
    (documented deviation from the reference, which resets its best values
    on every train() start, phiseg_model.py:180-184)."""
    data = _data(cfg)
    t1 = Trainer(cfg, device="cpu")
    t1.train(data, num_iter=11)
    assert os.path.exists(os.path.join(t1.log_dir, "best_metrics.json"))
    bests = dict(t1.best)
    assert bests["dice"] > -1.0  # a validation happened

    t2 = Trainer(cfg, device="cpu")
    assert t2.best == bests
    t2.best = {"dice": 2.0, "loss": -1e9, "ged": -1.0, "ncc": 2.0}
    tags = ("best_dice", "best_ged", "best_ncc", "best_loss")
    before = {tag: t2.ckpt.latest_step(tag) for tag in tags}
    t2.do_validation(data, step=11)
    t2.ckpt.wait()
    assert {tag: t2.ckpt.latest_step(tag) for tag in tags} == before

    t3 = Trainer(cfg.replace(persist_best_metrics=False), device="cpu")
    assert t3.best["dice"] == -1.0


@pytest.mark.parametrize("async_writes", [True, False])
def test_checkpointing_trainer(cfg, async_writes):
    c = cfg.replace(experiment_name=f"ckpt_{async_writes}", async_checkpointing=async_writes)
    t = Trainer(c, device="cpu")
    t.train(_data(c), num_iter=11)
    assert t.ckpt.has_checkpoint("latest") and t.ckpt.has_checkpoint("best_dice")
    # tags saved from one snapshot at one step share an inode
    inodes = {os.stat(p).st_ino for p in glob.glob(os.path.join(t.log_dir, "model_best_*-11.pt"))}
    assert len(inodes) == 1
    assert Trainer(c, device="cpu").init_step == 11


def test_train_drains_async_writer_on_exception(cfg):
    """A crash does not drop the writes queued at the last validation, and
    does not overwrite 'latest' with the live state."""
    c = cfg.replace(experiment_name="drain_test", async_checkpointing=True)
    t = Trainer(c, device="cpu")

    class Boom(RuntimeError):
        pass

    orig = t.do_validation

    def boom(*a, **k):
        orig(*a, **k)  # queues latest + best_* writes on the writer
        raise Boom()

    t.do_validation = boom
    with pytest.raises(Boom):
        t.train(_data(c), num_iter=11)
    assert t.ckpt.has_checkpoint("best_dice") and t.ckpt.has_checkpoint("latest")
    assert os.path.exists(os.path.join(t.log_dir, "best_metrics.json"))
    # the validation-time save (state.step 11 after loop step 10), not a
    # save of the live state after the crash
    assert t.ckpt.latest_step("latest") == 11


class _SameBatch:
    """A provider that hands out the same batch every time."""

    def __init__(self, x, s):
        self.x, self.s = x, s

    def next_batch(self, batch_size):
        return self.x[:batch_size].copy(), self.s[:batch_size].copy()


def test_resumed_run_equals_the_unbroken_run_bitwise(tmp_path):
    """3 steps, a validation, the final save; resume; 2 more steps: the
    model, the optimiser, the step and the generator equal those of 5 steps
    in one run, bit for bit. BN and on-device augmentation on, so the
    running statistics and the generator's position both matter."""
    cfg = ExperimentConfig(**dict(BASE, norm="batch", augment_on_device=True,
                                  validation_frequency=2, tensorboard_update_frequency=1,
                                  do_image_summaries=False, do_histogram_summaries=False))
    data = _data(cfg)
    x, s = data.train.next_batch(4)
    data.train = _SameBatch(x, s)

    whole = Trainer(cfg, log_dir=str(tmp_path / "whole"), device="cpu")
    whole.train(data, num_iter=5)
    first = Trainer(cfg, log_dir=str(tmp_path / "split"), device="cpu")
    first.train(data, num_iter=3)
    second = Trainer(cfg, log_dir=str(tmp_path / "split"), device="cpu")
    assert second.init_step == 3
    second.train(data, num_iter=5)

    a, b = whole.state, second.state
    assert a.step == b.step == 5
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert torch.equal(whole.generator.get_state(), second.generator.get_state())
    steps = lambda d: [json.loads(line)["step"]  # noqa: E731
                       for line in open(tmp_path / d / "metrics.jsonl")]
    assert steps("whole") == steps("split") == [0, 1, 2, 2, 3, 4, 4]


def test_cli_mesh_two_ranks_validate_on_rank_0(cfg, tmp_path):
    """--mesh 2 --device cpu with a validation step: rank 0 validates and
    writes while rank 1 waits at the broadcast; both reach the last step
    (timeout 120 s for the ranks)."""
    path = str(tmp_path / "cfg.json")
    cfg.replace(validation_frequency=2, tensorboard_update_frequency=1, synth_n_train=16,
                synth_n_val=4, synth_n_test=4, do_histogram_summaries=False).save(path)
    log_dir = tmp_path / "log"
    ranks = cli_main([path, "--num-iter", "3", "--log-dir", str(log_dir), "--device", "cpu",
                      "--mesh", "2"], timeout=120)
    assert [step for step, _ in ranks] == [3, 3]
    recs = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1, 2, 2]
    val = recs[3]
    assert all(math.isfinite(val[k]) for k in ("validation_GED", "validation_NCC",
                                               "validation_neg_elbo"))
    assert sorted(p.name for p in log_dir.glob("model*.pt")) == [
        "model.ckpt-3.pt", "model_best_dice.ckpt-3.pt", "model_best_ged.ckpt-3.pt",
        "model_best_loss.ckpt-3.pt", "model_best_ncc.ckpt-3.pt"]


class _Numbered:
    """A provider whose k-th batch holds (10 k + i) / 100 in image i."""

    def __init__(self, hw):
        self.hw, self.k = hw, 0

    def next_batch(self, batch_size):
        x = _numbered(self.k, batch_size)[:, None, None, None] * np.ones((1, *self.hw, 1),
                                                                         np.float32)
        self.k += 1
        return x, np.zeros((batch_size, *self.hw), np.uint8)


def _numbered(k, batch_size):
    return ((10 * k + np.arange(batch_size)) / 100).astype(np.float32)


def _trained_images(cfg_json, log_dir, num_iter):
    """One rank of a 2-rank run (a process of its own): the first pixel of
    each image that its train step got, step by step."""
    cfg = ExperimentConfig.from_json(cfg_json)
    data = _data(cfg)
    data.train = _Numbered(cfg.image_hw)
    trainer = Trainer(cfg, log_dir=log_dir, device="cpu", mesh=make_mesh(2, device="cpu"))
    seen, step = [], trainer.train_step

    def record(state, x, s, generator):
        seen.append(x[:, 0, 0, 0].tolist())
        return step(state, x, s, generator)

    trainer.train_step = record
    trainer.train(data, num_iter=num_iter)
    return seen


def test_mesh_ranks_train_on_one_global_batch_across_validations(cfg, tmp_path):
    """With validations at steps 2, 4 and 6, each takes the next batch off
    every rank's stream, and each step's rank slices come from one global
    batch: batches 0, 1, 2, 4, 5, 7, 8, 10 on both ranks (timeout 120 s)."""
    c = cfg.replace(validation_frequency=2, do_image_summaries=False,
                    do_histogram_summaries=False)
    seen = spawn_ranks(_trained_images, 2, (c.to_json(), str(tmp_path / "log"), 8),
                       backend="gloo", timeout=120)
    half = c.batch_size // 2
    for rank, got in enumerate(seen):
        want = [_numbered(k, c.batch_size)[rank * half:(rank + 1) * half].tolist()
                for k in (0, 1, 2, 4, 5, 7, 8, 10)]
        assert got == want, (rank, got)
