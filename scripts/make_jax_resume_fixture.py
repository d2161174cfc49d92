"""Write the phiseg_tpu log dirs that the port's Trainer resumes in its tests
and in chip_smoke.py.

  JAX_PLATFORMS=cpu python scripts/make_jax_resume_fixture.py
  JAX_PLATFORMS=cpu python scripts/make_jax_resume_fixture.py --out some/dir

The JAX package's Trainer trains two tiny models on the CPU on synthetic
data (the configs' seed 42, the synthetic arrays' seed 0), with validation
every 2 steps and no augmentation, to step 3:

  detunet/          a deterministic U-Net (R=4, n0=2, 16x16, f32, batch
                    norm, Adam, annotator 0). Its training set is one batch
                    of 4 images, so every batch of the stream holds the same
                    images and a run's losses do not depend on which batch a
                    step takes: the JAX Trainer's validation takes its train
                    batch from the provider beside its prefetch thread, the
                    port's from the prefetch stream;
  detunet_batches/  the same U-Net on 16 training images, 4 batches: the
                    steps of a resumed run before its first validation (3
                    and 4) train on the batches the stream gives them, so
                    their losses show which batches a resumed run takes;
  phiseg/           a PHiSeg (L=2, R=4, n0=2, 16x16, f32, batch norm, Adam).

Each directory keeps the log dir's config.json, the `latest` checkpoint
model.ckpt-3.msgpack, best_metrics.json and metrics.jsonl; the best_*
checkpoints of the step-2 validation are left out to keep the fixture small.
expected.npz holds detunet/'s logged losses at steps 3-5 of the JAX Trainer
resumed from a copy of it to step 6, expected_batches.npz detunet_batches/'s
at steps 3-4 of a resume to step 5: `steps` and one array `batch_<loss>` per
loss (tests/test_torch_resume.py, chip_smoke.py phase 21).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "jax_logdir_resume")
STEP, RESUME_TO = 3, 6
# the runs the JAX Trainer resumes for their losses: case -> (file, resume to)
EXPECTED = {"detunet": ("expected.npz", RESUME_TO),
            "detunet_batches": ("expected_batches.npz", 5)}
KEPT = ("config.json", f"model.ckpt-{STEP}.msgpack", "best_metrics.json", "metrics.jsonl")
_COMMON = dict(
    latent_levels=2, resolution_levels=4, n0=2, zdim0=2, image_size=(16, 16, 1),
    compute_dtype="float32", norm="batch", data_identifier="synthetic", synth_n_val=4,
    synth_n_test=4, batch_size=4, num_iter=STEP, validation_frequency=2,
    tensorboard_update_frequency=1, num_validation_images=4, validation_samples=3,
    validation_elbo_samples=2, augment_on_device=False, do_image_summaries=False,
    do_histogram_summaries=False, async_checkpointing=False,
)
CONFIGS = {
    "detunet": dict(_COMMON, experiment_name="jax_resume_detunet", model_family="det_unet",
                    latent_levels=1, annotator_range=(0,), kl_divergence_loss_weight=None,
                    synth_n_train=4),
    "detunet_batches": dict(_COMMON, experiment_name="jax_resume_detunet_batches",
                            model_family="det_unet", latent_levels=1, annotator_range=(0,),
                            kl_divergence_loss_weight=None, synth_n_train=16),
    "phiseg": dict(_COMMON, experiment_name="jax_resume_phiseg", model_family="phiseg",
                   synth_n_train=8),
}


def _train(log_dir: str, num_iter: int) -> None:
    """phiseg_tpu's Trainer on the log dir's config (or, for a new dir, none
    given: the caller writes config.json first), up to num_iter."""
    from phiseg_tpu.data import get_dataset
    from phiseg_tpu.engine.config import ExperimentConfig
    from phiseg_tpu.engine.trainer import Trainer

    cfg = ExperimentConfig.load(os.path.join(log_dir, "config.json"))
    Trainer(cfg, log_dir=log_dir).train(get_dataset(cfg), num_iter=num_iter)


def write_log_dir(name: str, out_dir: str) -> None:
    """Train CONFIGS[name] to STEP into a scratch log dir and copy KEPT to out_dir."""
    from phiseg_tpu.engine.config import ExperimentConfig

    with tempfile.TemporaryDirectory() as tmp:
        log_dir = os.path.join(tmp, "log")
        os.makedirs(log_dir)
        ExperimentConfig(**CONFIGS[name]).save(os.path.join(log_dir, "config.json"))
        _train(log_dir, STEP)
        os.makedirs(out_dir, exist_ok=True)
        for f in KEPT:
            shutil.copy(os.path.join(log_dir, f), out_dir)


def resumed_losses(log_dir: str, resume_to: int = RESUME_TO) -> dict:
    """The logged losses of steps STEP..resume_to-1 of phiseg_tpu's Trainer
    resumed from a copy of log_dir: {"steps": ..., "batch_<loss>": ...}."""
    with tempfile.TemporaryDirectory() as tmp:
        copy = os.path.join(tmp, "log")
        shutil.copytree(log_dir, copy)
        _train(copy, resume_to)
        with open(os.path.join(copy, "metrics.jsonl")) as f:
            recs = [r for r in map(json.loads, f)
                    if STEP <= r["step"] < resume_to and "batch_total_loss" in r]
    keys = sorted(k for k in recs[0] if k.startswith("batch_"))
    out = {"steps": np.array([r["step"] for r in recs])}
    out.update({k: np.array([r[k] for r in recs]) for k in keys})
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        # the JAX Trainer's advisory lock file, kept out of the machine's
        os.environ.setdefault("PHISEG_TPU_LOCK", os.path.join(tmp, "tpu.lock"))
        shutil.rmtree(args.out, ignore_errors=True)
        for name in CONFIGS:
            write_log_dir(name, os.path.join(args.out, name))
        for name, (file, resume_to) in EXPECTED.items():
            np.savez(os.path.join(args.out, file),
                     **resumed_losses(os.path.join(args.out, name), resume_to))
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(args.out) for f in fs)
    print(f"wrote {args.out}: {size} bytes", file=sys.stderr)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
