"""Write a small phiseg_tpu log dir for the port's checkpoint-reader tests.

  JAX_PLATFORMS=cpu python scripts/make_jax_checkpoint_fixture.py
  JAX_PLATFORMS=cpu python scripts/make_jax_checkpoint_fixture.py --out some/dir

The JAX package's Trainer trains a tiny PHiSeg (R=4, L=2, n0=2, 16x16, f32,
batch norm, Adam) on synthetic data for NUM_ITER steps with one validation,
on the CPU. The output directory keeps its `config.json` and its
`model_best_ged.ckpt-<step>.msgpack`, and gets `expected.npz`: the inputs
`x` and `s`, the prior noise `eps_prior_<level>` (S, B, h, w, zdim) that
JAX's `make_sample_fn` draws with PRNGKey(SAMPLE_KEY), its probabilities
`probs` (S, B, H, W, C), the posterior noise `eps_post_<level>` of JAX's
eval-mode forward with PRNGKey(LOSS_KEY) and its eval-loss dict as
`loss_<name>`. The port is given the noise; the JAX package reproduces
everything from the checkpoint and the keys (tests/test_torch_msgpack.py).
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "jax_checkpoint_small")
NUM_ITER = 3
SAMPLES = 4
SAMPLE_KEY, LOSS_KEY = 7, 8
CONFIG = dict(
    experiment_name="jax_checkpoint_small", model_family="phiseg", latent_levels=2,
    resolution_levels=4, n0=2, zdim0=2, image_size=(16, 16, 1), compute_dtype="float32",
    norm="batch", data_identifier="synthetic", synth_n_train=16, synth_n_val=4,
    synth_n_test=4, batch_size=4, num_iter=NUM_ITER, validation_frequency=2,
    tensorboard_update_frequency=1, num_validation_images=4, validation_samples=3,
    validation_elbo_samples=2, augment_on_device=False, do_image_summaries=False,
    do_histogram_summaries=False, async_checkpointing=False,
)


def restore(log_dir: str):
    """(cfg, model, TrainState, step) of the log dir's best_ged checkpoint,
    restored by the JAX package."""
    import jax

    from phiseg_tpu.engine.checkpoint import CheckpointManager
    from phiseg_tpu.engine.config import ExperimentConfig
    from phiseg_tpu.engine.train import build_model, create_train_state, make_optimizer

    cfg = ExperimentConfig.load(os.path.join(log_dir, "config.json"))
    model = build_model(cfg)
    # the structure only: shapes from jax.eval_shape, filled by the restore
    template = jax.eval_shape(lambda k: create_train_state(model, cfg, k, make_optimizer(cfg)),
                              jax.random.PRNGKey(0))
    state, step = CheckpointManager(log_dir).restore(template, "best_ged")
    return cfg, model, state, step


def expected_arrays(cfg, model, state) -> dict:
    """The inputs, noise and JAX outputs that expected.npz holds."""
    import jax
    import jax.numpy as jnp

    from phiseg_tpu.data import get_dataset
    from phiseg_tpu.engine.train import make_eval_loss_fn, make_sample_fn

    data = get_dataset(cfg)
    x = np.asarray(data.test.images[:2], np.float32)[..., None]
    s = np.asarray(data.test.labels[:2, ..., 0], np.int32)
    v = state.variables
    out = {"x": x, "s": s}

    key = jax.random.PRNGKey(SAMPLE_KEY)
    out["probs"] = np.asarray(make_sample_fn(model, SAMPLES)(v, jnp.asarray(x), key))
    per_draw = []
    for k in jax.random.split(key, SAMPLES):
        z, mu, sigma = model.apply(v, jnp.asarray(x), k, method="prior_draw")
        per_draw.append([(np.asarray(a) - np.asarray(m)) / np.asarray(sg)
                         for a, m, sg in zip(z, mu, sigma)])
    for i in range(len(per_draw[0])):
        out[f"eps_prior_{i}"] = np.stack([d[i] for d in per_draw])

    key = jax.random.PRNGKey(LOSS_KEY)
    s_oh = jax.nn.one_hot(jnp.asarray(s), cfg.nlabels)
    fwd = model.apply(v, jnp.asarray(x), s_oh, key, train=False)
    for i, (z, mu, sigma) in enumerate(zip(fwd.z, fwd.q_mu, fwd.q_sigma)):
        out[f"eps_post_{i}"] = (np.asarray(z) - np.asarray(mu)) / np.asarray(sigma)
    losses = make_eval_loss_fn(model, cfg)(v, jnp.asarray(x), jnp.asarray(s), key)
    for name, val in losses.items():
        out[f"loss_{name}"] = np.asarray(val)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)

    from phiseg_tpu.data import get_dataset
    from phiseg_tpu.engine.config import ExperimentConfig
    from phiseg_tpu.engine.trainer import Trainer

    cfg = ExperimentConfig(**CONFIG)
    with tempfile.TemporaryDirectory() as tmp:
        log_dir = os.path.join(tmp, "log")
        Trainer(cfg, log_dir=log_dir).train(get_dataset(cfg))
        (ckpt,) = glob.glob(os.path.join(log_dir, "model_best_ged.ckpt-*.msgpack"))
        shutil.rmtree(args.out, ignore_errors=True)
        os.makedirs(args.out)
        shutil.copy(os.path.join(log_dir, "config.json"), args.out)
        shutil.copy(ckpt, args.out)
    cfg, model, state, step = restore(args.out)
    np.savez(os.path.join(args.out, "expected.npz"), **expected_arrays(cfg, model, state))
    size = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
    print(f"wrote {args.out}: step {step}, {size} bytes", file=sys.stderr)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
