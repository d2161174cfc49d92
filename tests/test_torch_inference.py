"""The port's InferenceEngine vs phiseg_tpu's, method by method, on the CPU.

Both engines hold the same weights (flax variables converted by
phiseg_tpu_torch.convert, batch statistics far from (0, 1): every method
runs in eval batch-norm mode), in f32. The port is given JAX's own noise:
eps = (z - mu) / sigma of `prior_draw` with each key of split(key, S) (the
keys JAX's sampler decodes), or of `prior_draw` / `posterior_draw` with the
key itself. Tolerance rtol 1e-4 / atol 1e-4, as the sampler's test; label
maps agree except at near-ties of the mean softmax (|p1 - p0| < 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiseg_tpu.engine.config import ExperimentConfig as JaxConfig
from phiseg_tpu.engine.inference import InferenceEngine as JaxEngine
from phiseg_tpu.engine.train import build_model as jax_build_model
from phiseg_tpu_torch.convert import flax_to_state_dict
from phiseg_tpu_torch.engine.checkpoint import CheckpointManager
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.inference import InferenceEngine
from phiseg_tpu_torch.engine.train import create_train_state

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
TIE = 1e-5
S = 4
CFG = dict(model_family="phiseg", latent_levels=3, resolution_levels=5, n0=4, zdim0=2,
           image_size=(32, 32, 1), compute_dtype="float32", norm="batch")


@pytest.fixture(scope="module")
def engines():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 1).astype(np.float32)
    s = (rng.rand(2, 32, 32) > 0.6).astype(np.int32)
    jcfg = JaxConfig(**CFG)
    jmod = jax_build_model(jcfg)
    s_oh = jax.nn.one_hot(jnp.asarray(s), 2)
    shapes = jax.eval_shape(lambda k: jmod.init({"params": k}, jnp.asarray(x), s_oh, k,
                                                train=True), jax.random.PRNGKey(0))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*leaf.shape) * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)  # scale, var

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    tcfg = ExperimentConfig(**CFG)
    state = create_train_state(tcfg, device="cpu")
    state.model.load_state_dict(flax_to_state_dict(variables, state.model))
    return dict(x=x, s=s, jmod=jmod, variables=variables, jeng=JaxEngine(jcfg, jmod, variables),
                teng=InferenceEngine(tcfg, state.model), tcfg=tcfg, state=state)


def _eps(draw):
    z, mu, sigma = draw
    return [torch.from_numpy((np.asarray(a) - np.asarray(m)) / np.asarray(sg))
            for a, m, sg in zip(z, mu, sigma)]


def _prior_eps(e, key):
    return _eps(e["jmod"].apply(e["variables"], jnp.asarray(e["x"]), key, method="prior_draw"))


def _sampler_eps(e, key, n):
    per_draw = [_prior_eps(e, k) for k in jax.random.split(key, n)]
    return [torch.stack([d[i] for d in per_draw]) for i in range(len(per_draw[0]))]


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what, **TOL)


def _labels_close(got, want, mean_probs, what):
    """Label maps equal except where the (JAX) mean softmax is a near-tie."""
    got, want, p = got.numpy(), np.asarray(want), np.asarray(mean_probs)
    diff = got != want
    assert (np.abs(p[..., 1] - p[..., 0])[diff] < TIE).all(), what


def test_sample_probs_and_predict(engines):
    e = engines
    key = jax.random.PRNGKey(1)
    eps = _sampler_eps(e, key, S)
    _close(e["teng"].sample_probs(e["x"], S, eps=eps),
           e["jeng"].sample_probs(e["x"], key, S), "sample_probs")
    pred, mean = e["teng"].predict(e["x"], num_samples=S, return_softmax=True, eps=eps)
    jpred, jmean = e["jeng"].predict(e["x"], key, S, return_softmax=True)
    _close(mean, jmean, "predict softmax")
    _labels_close(pred, jpred, jmean, "predict")
    assert torch.equal(e["teng"].predict(e["x"], num_samples=S, eps=eps), pred)


def test_single_sample_and_levels(engines):
    e = engines
    key = jax.random.PRNGKey(2)
    eps = _sampler_eps(e, key, 1)
    probs = e["teng"].predict_segmentation_sample(e["x"], return_softmax=True, eps=eps)
    jprobs = e["jeng"].predict_segmentation_sample(e["x"], key, return_softmax=True)
    _close(probs, jprobs, "one sample")
    _labels_close(e["teng"].predict_segmentation_sample(e["x"], eps=eps),
                  e["jeng"].predict_segmentation_sample(e["x"], key), jprobs, "one sample mask")
    levels = e["teng"].predict_segmentation_sample_levels(e["x"], eps=eps)
    jlevels = e["jeng"].predict_segmentation_sample_levels(e["x"], key)
    assert len(levels) == len(jlevels) == 3
    for i, (g, w) in enumerate(zip(levels, jlevels)):
        _close(g, w, f"level {i}")


def test_variance_and_error_maps(engines):
    """ddof 0 in both the variance map (jnp.var) and the std of
    mean_variance_and_error_maps (jnp.std)."""
    e = engines
    key = jax.random.PRNGKey(3)
    eps = _sampler_eps(e, key, S)
    v = e["teng"].sample_variance_map(e["x"], num_samples=S, eps=eps)
    _close(v, e["jeng"].sample_variance_map(e["x"], key, S), "variance map")
    err = e["teng"].crossentropy_error_map(e["x"], e["s"], num_samples=S, eps=eps)
    _close(err, e["jeng"].crossentropy_error_map(e["x"], e["s"], key, S), "xent map")
    means, vars_, errs = e["teng"].mean_variance_and_error_maps(e["x"], e["s"], num_samples=S,
                                                                eps=eps)
    jmeans, jvars, jerrs = e["jeng"].mean_variance_and_error_maps(e["x"], e["s"], key, S)
    _close(vars_, jvars, "std map")
    _close(errs, jerrs, "error map")
    _labels_close(means, jmeans, e["jeng"].sample_probs(e["x"], key, S).mean(0), "means")
    assert v.shape == vars_.shape == (2, 32, 32) and float(v.min()) >= 0


def test_latent_access(engines):
    e = engines
    key = jax.random.PRNGKey(4)
    want = e["jeng"].generate_prior_samples(e["x"], key, return_params=True)
    got = e["teng"].generate_prior_samples(e["x"], return_params=True, eps=_eps(want))
    for what, g, w in zip(("z", "mu", "sigma"), got, want):
        for i, (gi, wi) in enumerate(zip(g, w)):
            _close(gi, wi, f"prior {what}[{i}]")
    z = e["teng"].generate_prior_samples(e["x"], eps=_eps(want))
    assert len(z) == 3 and all(torch.equal(a, b) for a, b in zip(z, got[0]))

    key = jax.random.PRNGKey(5)
    want = e["jeng"].generate_posterior_samples(e["x"], e["s"], key, return_params=True)
    got = e["teng"].generate_posterior_samples(e["x"], e["s"], return_params=True,
                                               eps=_eps(want))
    for what, g, w in zip(("z", "mu", "sigma"), got, want):
        for i, (gi, wi) in enumerate(zip(g, w)):
            _close(gi, wi, f"posterior {what}[{i}]")

    zj = want[0]
    zt = [np.array(t) for t in zj]
    _close(e["teng"].generate_samples_from_z(zt, e["x"]),
           e["jeng"].generate_samples_from_z(zj, e["x"]), "decode aggregate")
    levels = e["teng"].generate_samples_from_z(zt, e["x"], output_all_levels=True)
    jlevels = e["jeng"].generate_samples_from_z(zj, e["x"], output_all_levels=True)
    for i, (g, w) in enumerate(zip(levels, jlevels)):
        _close(g, w, f"decode level {i}")


def test_methods_draw_from_the_generator_in_eval_mode(engines):
    e = engines
    model = e["teng"].model
    model.train()
    a = e["teng"].predict(e["x"], torch.Generator().manual_seed(0), num_samples=3)
    b = e["teng"].predict(e["x"], torch.Generator().manual_seed(0), num_samples=3)
    assert torch.equal(a, b) and model.training
    model.eval()


def test_from_logdir(engines, tmp_path):
    e = engines
    log_dir = str(tmp_path)
    e["tcfg"].save(str(tmp_path / "config.json"))
    CheckpointManager(log_dir).save(e["state"], "best_ged", step=3)
    eng = InferenceEngine.from_logdir(log_dir, "best_ged", device="cpu")
    for k, v in e["state"].model.state_dict().items():
        assert torch.equal(eng.model.state_dict()[k], v), k
    g = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    assert torch.equal(eng.predict(e["x"], g(), 3), e["teng"].predict(e["x"], g(), 3))
    with pytest.raises(FileNotFoundError):
        InferenceEngine.from_logdir(log_dir, "best_dice", device="cpu")
