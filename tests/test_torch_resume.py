"""The port's Trainer carries on a run that phiseg_tpu's Trainer wrote, on the CPU.

A module fixture runs scripts/make_jax_resume_fixture.py into a scratch
directory: phiseg_tpu's Trainer trains a tiny DetUNet (augmentation off, f32,
its training set one batch), the same DetUNet on four batches and a tiny
PHiSeg to step 3, and resumes the one-batch DetUNet to step 6 for its losses
at steps 3-5 and the four-batch one to step 5 for those at steps 3-4. Then:
  * the committed fixture tests/data/jax_logdir_resume (chip_smoke.py phase
    21 resumes it on the card) is what the script writes;
  * the port's Trainer resumes each log dir at step 3 with optax's weights,
    batch-norm statistics, Adam moments and count, its generator seeded from
    the step; the one-batch DetUNet's next three losses match the JAX
    Trainer's resumed run within LOSS_RTOL, and so do the four-batch
    DetUNet's next two, which show that the resumed run trains on the
    batches JAX's does;
  * the PHiSeg run trains to 6 and writes a `.pt` latest beside the
    `.msgpack` files, which stay as they were, as does config.json; the JAX
    package still reads the dir; a second resume takes the `.pt` and its
    generator state bit for bit;
  * a config of another model raises, naming the field; a fresh run
    replaces a config.json it cannot read; the CLI, with and without
    --mesh, resumes the dir too.

LOSS_RTOL 1e-4, fixed before the first run, as one resumed step is held in
tests/test_torch_msgpack.py: f32 convolutions and batch statistics summed in
another order, over three Adam steps.
"""

import filecmp
import glob
import importlib.util
import json
import os
import shutil

import flax.serialization as fser
import jax
import numpy as np
import pytest
import torch

from phiseg_tpu.engine.checkpoint import CheckpointManager as JaxCheckpointManager
from phiseg_tpu.engine.config import ExperimentConfig as JaxConfig
from phiseg_tpu.engine.train import build_model as jax_build_model
from phiseg_tpu.engine.train import create_train_state as jax_create_train_state
from phiseg_tpu.engine.train import make_optimizer as jax_make_optimizer
from phiseg_tpu_torch.cli.train import main as cli_main
from phiseg_tpu_torch.convert import flax_to_state_dict
from phiseg_tpu_torch.data import get_dataset
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.trainer import Trainer, rank_seed

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "jax_logdir_resume")
LOSS_RTOL = 1e-4
JAX_SELF_TOL = dict(rtol=1e-5, atol=1e-6)  # the JAX package against its own earlier run


def _script():
    spec = importlib.util.spec_from_file_location(
        "make_resume_fixture", os.path.join(ROOT, "scripts", "make_jax_resume_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT = _script()


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """The script's output, written now by the JAX package."""
    out = str(tmp_path_factory.mktemp("jax_resume") / "fixture")
    with pytest.MonkeyPatch.context() as mp:  # the JAX trainer's advisory lock file
        mp.setenv("PHISEG_TPU_LOCK", os.path.join(os.path.dirname(out), "tpu.lock"))
        SCRIPT.main(["--out", out])
    return out


def _copy(src, tmp_path, name):
    dst = str(tmp_path / name)
    shutil.copytree(src, dst)
    return dst


def _port_cfg(name):
    """The port's config built from the script's kwargs, not read back."""
    return ExperimentConfig(**SCRIPT.CONFIGS[name])


def _jax_state(log_dir):
    cfg = JaxConfig.load(os.path.join(log_dir, "config.json"))
    model = jax_build_model(cfg)
    template = jax.eval_shape(
        lambda k: jax_create_train_state(model, cfg, k, jax_make_optimizer(cfg)),
        jax.random.PRNGKey(0))
    return JaxCheckpointManager(log_dir).restore(template, "latest")


def _assert_state_is_optax(trainer, log_dir):
    jstate, step = _jax_state(log_dir)
    model, opt = trainer.state.model, trainer.state.optimizer
    assert step == trainer.init_step == trainer.state.step == int(jstate.step) == SCRIPT.STEP
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.variables), model)
    for name, t in model.state_dict().items():  # weights and BN statistics
        assert torch.equal(t, want[name]), name
    adam = jstate.opt_state[0]
    bs = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    mu = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, adam.mu),
                             "batch_stats": bs}, model)
    nu = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, adam.nu),
                             "batch_stats": bs}, model)
    for name, p in model.named_parameters():
        st = opt.state[p]
        assert float(st["step"]) == int(adam.count) == SCRIPT.STEP, name
        assert torch.equal(st["exp_avg"], mu[name]) and torch.equal(st["exp_avg_sq"], nu[name])


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _snapshot(log_dir):
    """{file name: bytes} of the JAX package's config.json and checkpoint in
    a log dir (a resumed run appends to metrics.jsonl and updates
    best_metrics.json)."""
    out = {}
    for f in ("config.json", f"model.ckpt-{SCRIPT.STEP}.msgpack"):
        with open(os.path.join(log_dir, f), "rb") as fh:
            out[f] = fh.read()
    return out


# -- the committed fixture ------------------------------------------------------------


def _tree_close(got, want, path="."):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _tree_close(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=path,
                                   **JAX_SELF_TOL)


@pytest.mark.parametrize("name", sorted(SCRIPT.CONFIGS))
def test_jax_package_reproduces_the_resume_fixture(fresh, name):
    """The committed log dirs are what the script writes: config.json byte
    for byte, the checkpoint, best_metrics.json and the logged losses within
    JAX_SELF_TOL."""
    got, want = os.path.join(fresh, name), os.path.join(FIXTURE, name)
    assert sorted(os.listdir(want)) == sorted(os.listdir(got)) == sorted(SCRIPT.KEPT)
    assert filecmp.cmp(os.path.join(got, "config.json"), os.path.join(want, "config.json"),
                       shallow=False)
    ckpt = f"model.ckpt-{SCRIPT.STEP}.msgpack"
    trees = []
    for d in (got, want):
        with open(os.path.join(d, ckpt), "rb") as f:
            trees.append(fser.msgpack_restore(f.read()))
    _tree_close(*trees)
    for d in (got, want):
        with open(os.path.join(d, "best_metrics.json")) as f:
            trees.append(json.load(f))
    _tree_close(trees[2], trees[3])
    losses = [[{k: v for k, v in r.items() if k != "images_per_sec"} for r in _records(d)]
              for d in (got, want)]
    assert [sorted(r) for r in losses[0]] == [sorted(r) for r in losses[1]]
    for a, b in zip(*losses):
        _tree_close(a, b)


def test_jax_package_reproduces_the_expected_losses(fresh):
    for file, resume_to in SCRIPT.EXPECTED.values():
        got = dict(np.load(os.path.join(fresh, file)))
        want = dict(np.load(os.path.join(FIXTURE, file)))
        assert sorted(got) == sorted(want)
        assert list(want["steps"]) == list(range(SCRIPT.STEP, resume_to))
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=f"{file} {k}", **JAX_SELF_TOL)


# -- the port resumes ------------------------------------------------------------------


def test_port_carries_on_a_jax_detunet_run_with_jax_losses(fresh, tmp_path):
    log_dir = _copy(os.path.join(fresh, "detunet"), tmp_path, "detunet")
    before = _snapshot(log_dir)
    cfg = _port_cfg("detunet")
    trainer = Trainer(cfg, log_dir=log_dir, device="cpu")
    assert trainer.resumed_from == (SCRIPT.STEP, ".msgpack")
    _assert_state_is_optax(trainer, log_dir)
    assert torch.equal(trainer.generator.get_state(), torch.Generator().manual_seed(
        rank_seed(cfg.seed + 1 + SCRIPT.STEP, 0)).get_state())
    with open(os.path.join(log_dir, "best_metrics.json")) as f:
        assert trainer.best == {k: float(v) for k, v in json.load(f).items()}

    trainer.train(get_dataset(cfg), num_iter=SCRIPT.RESUME_TO)
    want = dict(np.load(os.path.join(fresh, "expected.npz")))
    recs = [r for r in _records(log_dir) if "batch_total_loss" in r]
    got = [r for r in recs if r["step"] >= SCRIPT.STEP]
    assert [r["step"] for r in recs[:len(recs) - len(got)]] == [0, 1, 2]  # appended to
    assert [r["step"] for r in got] == list(want["steps"])
    for k in (k for k in want if k != "steps"):
        np.testing.assert_allclose([r[k] for r in got], want[k], rtol=LOSS_RTOL, err_msg=k)
    assert _snapshot(log_dir) == before  # config.json and the .msgpack as they were
    assert trainer.ckpt.latest_step("latest") == SCRIPT.RESUME_TO


def test_port_feeds_a_resumed_jax_run_the_batches_jax_feeds_it(fresh, tmp_path):
    """Four batches of four images: a resumed run that took other batches of
    the stream than the JAX Trainer's would give other losses at steps 3-4
    (the two differ by far more than LOSS_RTOL)."""
    file, resume_to = SCRIPT.EXPECTED["detunet_batches"]
    log_dir = _copy(os.path.join(fresh, "detunet_batches"), tmp_path, "detunet_batches")
    cfg = _port_cfg("detunet_batches")
    trainer = Trainer(cfg, log_dir=log_dir, device="cpu")
    _assert_state_is_optax(trainer, log_dir)
    trainer.train(get_dataset(cfg), num_iter=resume_to)
    want = dict(np.load(os.path.join(fresh, file)))
    got = [r for r in _records(log_dir) if "batch_total_loss" in r and r["step"] >= SCRIPT.STEP]
    assert [r["step"] for r in got] == list(want["steps"]) == [3, 4]
    assert abs(want["batch_total_loss"][1] / want["batch_total_loss"][0] - 1) > 100 * LOSS_RTOL
    for k in (k for k in want if k != "steps"):
        np.testing.assert_allclose([r[k] for r in got], want[k], rtol=LOSS_RTOL, err_msg=k)


def test_port_carries_on_a_jax_phiseg_run_and_resumes_its_own(fresh, tmp_path):
    log_dir = _copy(os.path.join(fresh, "phiseg"), tmp_path, "phiseg")
    before = _snapshot(log_dir)
    cfg = _port_cfg("phiseg")
    data = get_dataset(cfg)
    first = Trainer(cfg, log_dir=log_dir, device="cpu")
    _assert_state_is_optax(first, log_dir)
    first.train(data, num_iter=SCRIPT.RESUME_TO)
    assert glob.glob(os.path.join(log_dir, f"model.ckpt-{SCRIPT.RESUME_TO}.pt"))
    recs = _records(log_dir)
    assert [r["step"] for r in recs if "batch_total_loss" in r] == list(range(SCRIPT.RESUME_TO))
    assert all(np.isfinite(r["batch_total_loss"]) for r in recs if "batch_total_loss" in r)
    assert [r["step"] for r in recs if "validation_GED" in r] == [2, 4]
    assert _snapshot(log_dir) == before  # config.json and the .msgpack as they were

    # the JAX package still reads the dir: its config and its own latest
    assert JaxConfig.load(os.path.join(log_dir, "config.json")) == JaxConfig(
        **SCRIPT.CONFIGS["phiseg"])
    assert JaxCheckpointManager(log_dir).latest_step("latest") == SCRIPT.STEP
    assert int(_jax_state(log_dir)[0].step) == SCRIPT.STEP

    second = Trainer(cfg, log_dir=log_dir, device="cpu")  # the port's own .pt now
    assert second.resumed_from == (SCRIPT.RESUME_TO, ".pt")
    assert second.init_step == SCRIPT.RESUME_TO
    assert torch.equal(second.generator.get_state(), first.generator.get_state())
    for (name, a), b in zip(first.state.model.state_dict().items(),
                            second.state.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_a_resume_that_takes_no_step_writes_no_pt(fresh, tmp_path):
    """A `.pt` of the `.msgpack`'s own step would make `latest` ambiguous."""
    log_dir = _copy(os.path.join(fresh, "detunet"), tmp_path, "detunet")
    cfg = _port_cfg("detunet")
    Trainer(cfg, log_dir=log_dir, device="cpu").train(get_dataset(cfg), num_iter=SCRIPT.STEP)
    assert not glob.glob(os.path.join(log_dir, "*.pt"))
    assert Trainer(cfg, log_dir=log_dir, device="cpu").resumed_from == (SCRIPT.STEP,
                                                                          ".msgpack")


@pytest.mark.parametrize("field,value", [("n0", 4), ("norm", "group"), ("model_family",
                                                                         "phiseg")])
def test_resume_refuses_a_config_of_another_model(tmp_path, field, value):
    log_dir = _copy(os.path.join(FIXTURE, "detunet"), tmp_path, "detunet")
    cfg = _port_cfg("detunet").replace(**{field: value})
    with pytest.raises(ValueError, match=f"{field}=.* there, {value!r} here"):
        Trainer(cfg, log_dir=log_dir, device="cpu")
    trainer = Trainer(cfg, log_dir=log_dir, device="cpu", resume=False)  # afresh
    assert trainer.init_step == 0 and trainer.resumed_from is None


def test_a_fresh_run_replaces_a_config_it_cannot_read(tmp_path):
    """resume=False neither reads the log dir's config.json nor keeps it."""
    log_dir = _copy(os.path.join(FIXTURE, "detunet"), tmp_path, "detunet")
    path = os.path.join(log_dir, "config.json")
    with open(path) as f:
        d = json.load(f)
    d["a_field_of_another_version"] = 1
    with open(path, "w") as f:
        json.dump(d, f)
    cfg = _port_cfg("detunet")
    trainer = Trainer(cfg, log_dir=log_dir, device="cpu", resume=False)
    assert trainer.resumed_from is None
    assert ExperimentConfig.load(path) == cfg


@pytest.mark.parametrize("mesh", [None, 2])
def test_cli_carries_on_a_jax_run(tmp_path, mesh):
    """`python -m phiseg_tpu_torch.cli.train <dir>/config.json --log-dir <dir>`,
    alone and with 2 gloo ranks: from step 3 to --num-iter."""
    log_dir = _copy(os.path.join(FIXTURE, "detunet"), tmp_path, "detunet")
    args = [os.path.join(log_dir, "config.json"), "--log-dir", log_dir, "--device", "cpu",
            "--num-iter", "5"] + (["--mesh", str(mesh)] if mesh else [])
    out = cli_main(args, timeout=240)
    steps = [r[0] for r in out] if mesh else [out.state.step]
    assert steps == [5] * (mesh or 1)
    assert os.path.exists(os.path.join(log_dir, "model.ckpt-5.pt"))
    assert os.path.exists(os.path.join(log_dir, f"model.ckpt-{SCRIPT.STEP}.msgpack"))
    recs = [r for r in _records(log_dir) if "batch_total_loss" in r]
    assert [r["step"] for r in recs] == [0, 1, 2, 3, 4]
    assert all(np.isfinite(r["batch_total_loss"]) for r in recs)
    # --num-iter changed the config, so its snapshot is the new one
    assert ExperimentConfig.load(os.path.join(log_dir, "config.json")).num_iter == 5
