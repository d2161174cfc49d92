"""The port runs without jax: in a fresh interpreter where importing jax,
flax, optax, the JAX package, h5py or msgpack fails (the card's machine has
none of them), every module of phiseg_tpu_torch imports, and one CPU train
step (with on-device augmentation), one validation, a checkpoint save and
restore, a load of the committed phiseg_tpu checkpoint
(tests/data/jax_checkpoint_small) and the Trainer's resume of the committed
phiseg_tpu log dirs (tests/data/jax_logdir_resume) run, and the CUDA
library is neither built nor loaded."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, os, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "flax", "optax", "phiseg_tpu", "h5py", "msgpack")
for name in BLOCKED:
    sys.modules[name] = None  # any import of these now raises ImportError
import torch
torch.set_num_threads(1)
import phiseg_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(phiseg_tpu_torch.__path__, "phiseg_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from phiseg_tpu_torch.data.augment_device import make_augment_fn
from phiseg_tpu_torch.engine.train import create_train_state, make_train_step
from phiseg_tpu_torch.experiments import get_experiment
cfg = get_experiment("phiseg_7_5_synth").replace(
    latent_levels=3, resolution_levels=5, n0=4, image_size=(32, 32, 1), batch_size=2)
state = create_train_state(cfg, device="cpu")
step = make_train_step(cfg, make_augment_fn(cfg.augmentation_options, cfg.nlabels))
g = torch.Generator().manual_seed(0)
losses = step(state, torch.randn(2, 32, 32, 1), torch.randint(0, 2, (2, 32, 32), dtype=torch.uint8), g)
assert torch.isfinite(losses["total_loss"])
# one validation (metrics, K1's plain path, the ELBO) and a checkpoint round trip
import tempfile
from phiseg_tpu_torch.engine.checkpoint import CheckpointManager, host_snapshot
from phiseg_tpu_torch.engine.validation import make_validation_fn
cfg = cfg.replace(validation_samples=3, validation_elbo_samples=2)
dice, ged, sncc, elbo = make_validation_fn(state.model, cfg)(
    torch.randn(2, 32, 32, 1), torch.randint(0, 2, (2, 4, 32, 32)), torch.randint(0, 2, (2, 32, 32)), g)
assert dice.shape == (2, 2) and torch.isfinite(ged).all() and torch.isfinite(elbo)
with tempfile.TemporaryDirectory() as d:
    writer = CheckpointManager(d, async_writes=True)
    writer.save(host_snapshot(state, g), "best_ged")
    writer.close()  # the async write has published before the restore reads it
    fresh = create_train_state(cfg, device="cpu", seed=1)
    _, step = CheckpointManager(d).restore(fresh, "best_ged")
    assert step == 1 and all(torch.equal(a, b) for a, b in
                             zip(fresh.model.state_dict().values(), state.model.state_dict().values()))
# the phiseg_tpu checkpoint fixture, through the port's own msgpack decoder
import shutil
import numpy as np
from phiseg_tpu_torch.engine.loading import load_experiment
from phiseg_tpu_torch.engine.train import make_sample_fn
with tempfile.TemporaryDirectory() as d:
    shutil.copytree("tests/data/jax_checkpoint_small", d + "/log")
    _, model, jstate, jstep = load_experiment(d + "/log", "best_ged", device="cpu")
    exp = dict(np.load(d + "/log/expected.npz"))
    eps = [torch.from_numpy(exp[k]) for k in sorted(k for k in exp if k.startswith("eps_prior_"))]
    probs = make_sample_fn(model, exp["probs"].shape[0])(torch.from_numpy(exp["x"]), eps=eps)
    assert jstep == jstate.step > 0 and jstate.optimizer.state
    assert np.allclose(probs.numpy(), exp["probs"], rtol=1e-4, atol=1e-4)
# the phiseg_tpu log dirs of tests/data/jax_logdir_resume, carried on by the Trainer
from phiseg_tpu_torch.data import get_dataset
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.trainer import Trainer
for name in ("detunet", "phiseg"):
    with tempfile.TemporaryDirectory() as d:
        shutil.copytree("tests/data/jax_logdir_resume/" + name, d + "/log")
        cfg = ExperimentConfig.load(d + "/log/config.json")
        trainer = Trainer(cfg, log_dir=d + "/log", device="cpu")
        assert trainer.resumed_from == (3, ".msgpack") and trainer.state.optimizer.state
        trainer.train(get_dataset(cfg), num_iter=5)
        assert trainer.state.step == 5 and os.path.exists(d + "/log/model.ckpt-5.pt")
        assert os.path.exists(d + "/log/model.ckpt-3.msgpack")
# importing and running the CPU path neither built nor loaded the CUDA library
from phiseg_tpu_torch.ops import fused_residual_ce
assert fused_residual_ce._lib is None
leaked = sorted(k for k in sys.modules if k.split(".")[0] in BLOCKED
                and sys.modules[k] is not None)
assert not leaked, leaked
print("OK", len(mods))
"""


def test_port_imports_and_trains_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK"), proc.stdout
    assert int(proc.stdout.split()[1]) >= 25  # every module was walked


def test_chip_smoke_refuses_to_run_without_a_card():
    """On a machine without CUDA the check exits non-zero and prints no result."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
