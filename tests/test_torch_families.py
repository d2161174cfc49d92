"""The Probabilistic U-Net, the deterministic U-Net and PHiSeg at L=1: the
port vs phiseg_tpu on the CPU, and the three families through the port's
train, test_quantitative and test_predictions CLIs.

Each family is built at R=5, 32x32, n0=4, B=2 on both sides. The JAX model's
weights go to the port through phiseg_tpu_torch.convert, with non-trivial
biases, batch-norm scales and running statistics, so the eval mode is tested
too. JAX draws with threefry, which torch cannot reproduce, so the port is
given eps = (z - mu) / sigma of the JAX draw. Everything runs in f32.

Tolerances: the training forward at the models test's rtol 1e-3 / atol 1e-3
(train-mode batch norm at the coarsest level normalises over 8 values per
channel); the loss dict 1e-4 relative; the sampler and the eval-mode
methods rtol 1e-4 / atol 1e-4, as the sampler's test; the deterministic
U-Net's Dice 1e-6, since it is a ratio of pixel counts of the same masks.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiseg_tpu.engine.config import ExperimentConfig as JaxConfig
from phiseg_tpu.engine.objective import phiseg_objective as jax_objective
from phiseg_tpu.engine.train import make_sample_fn as jax_make_sample_fn
from phiseg_tpu.engine.train import make_sample_levels_fn as jax_make_sample_levels_fn
from phiseg_tpu.engine.validation import make_validation_fn as jax_make_validation_fn
from phiseg_tpu.metrics import dice_per_label as jax_dice_per_label
from phiseg_tpu.models import SegVAE as JaxSegVAE
from phiseg_tpu_torch.cli.test_predictions import main as pred_main
from phiseg_tpu_torch.cli.test_quantitative import main as quant_main
from phiseg_tpu_torch.cli.train import main as train_main
from phiseg_tpu_torch.convert import flax_to_state_dict
from phiseg_tpu_torch.data import get_dataset
from phiseg_tpu_torch.engine.checkpoint import CheckpointManager
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.inference import InferenceEngine
from phiseg_tpu_torch.engine.objective import phiseg_objective
from phiseg_tpu_torch.engine.train import (
    create_train_state,
    make_sample_fn,
    make_sample_levels_fn,
)
from phiseg_tpu_torch.engine.validation import make_validation_fn
from phiseg_tpu_torch.experiments import get_experiment, list_experiments
from phiseg_tpu_torch.models import SegVAE

torch.set_num_threads(1)
TOL = dict(rtol=1e-3, atol=1e-3)
EVAL_TOL = dict(rtol=1e-4, atol=1e-4)
S = 4
FAMILIES = {
    "prob_unet": dict(model_family="prob_unet", latent_levels=1, zdim0=6),
    "det_unet": dict(model_family="det_unet", latent_levels=1, zdim0=6),
    "phiseg_l1": dict(model_family="phiseg", latent_levels=1, zdim0=2),
}
COMMON = dict(resolution_levels=5, n0=4, nlabels=2, image_size=(32, 32), norm="batch")


def _fill(rng):
    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)  # scale, var

    return fill


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def fam(request):
    name = request.param
    kw = dict(FAMILIES[name], **COMMON)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 1).astype(np.float32)
    s = (rng.rand(2, 32, 32) > 0.6).astype(np.int64)
    s_oh = np.eye(2, dtype=np.float32)[s]
    jmod = JaxSegVAE(**kw)
    shapes = jax.eval_shape(lambda k: jmod.init({"params": k}, jnp.asarray(x), jnp.asarray(s_oh),
                                                k, train=True), jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map_with_path(_fill(rng), shapes)
    tmod = SegVAE(**kw, dtype=torch.float32, image_channels=1)
    tmod.load_state_dict(flax_to_state_dict(variables, tmod))
    tmod.eval()  # the JAX sampling methods run in eval batch-norm mode
    return dict(name=name, kw=kw, x=x, s=s, s_oh=s_oh, jmod=jmod, variables=variables,
                tmod=tmod)


def _eps(z, mu, sigma):
    return [torch.from_numpy((np.asarray(a) - np.asarray(m)) / np.asarray(sg))
            for a, m, sg in zip(z, mu, sigma)]


def _close(got, want, what, tol):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == np.shape(w), (what, i)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), err_msg=f"{what}[{i}]",
                                   **tol)


def _forward(m, train, key=jax.random.PRNGKey(1)):
    """JAX's training forward (and its batch statistics in train mode), and
    the port's on JAX's posterior noise, by a copy of the port model (a
    train-mode forward updates the running statistics)."""
    res = m["jmod"].apply(m["variables"], jnp.asarray(m["x"]), jnp.asarray(m["s_oh"]), key,
                          train=train, mutable=["batch_stats"] if train else False)
    want, mutated = res if train else (res, None)
    tmod = copy.deepcopy(m["tmod"]).train(train)
    with torch.no_grad():
        got = tmod(torch.from_numpy(m["x"]), torch.from_numpy(m["s_oh"]),
                   eps=_eps(want.z, want.q_mu, want.q_sigma))
    return want, mutated, got, tmod


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax(fam, train):
    want, mutated, got, tmod = _forward(fam, train)
    n_lat = 0 if fam["name"] == "det_unet" else 1
    for field in ("s_out_list", "z", "q_mu", "q_sigma", "p_mu", "p_sigma"):
        n = 1 if field == "s_out_list" else n_lat
        assert len(getattr(got, field)) == len(getattr(want, field)) == n, field
        _close(getattr(got, field), getattr(want, field), field, TOL)
    if fam["name"] == "prob_unet":  # one global (B, zdim) latent
        assert got.z[0].shape == (2, 6) and got.p_sigma[0].shape == (2, 6)
    if train:
        want_stats = flax_to_state_dict({"batch_stats": mutated["batch_stats"],
                                         "params": fam["variables"]["params"]}, tmod)
        for name, t in tmod.state_dict().items():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(t.numpy(), want_stats[name].numpy(), err_msg=name,
                                           **TOL)


@pytest.mark.parametrize("train", [True, False])
def test_loss_dict_matches_jax(fam, train):
    """The objective on each side's own forward, train or eval batch norm:
    the keys are JAX's (one KL level, weight 4^0, for the Probabilistic
    U-Net; none for the deterministic U-Net) and the values agree."""
    kw = dict(model_family=FAMILIES[fam["name"]]["model_family"], weight_decay_weight=1e-5)
    if fam["name"] == "det_unet":
        kw["kl_divergence_loss_weight"] = None
    want_out, _, got_out, tmod = _forward(fam, train=train)
    _, want = jax_objective(want_out, jnp.asarray(fam["s_oh"]), JaxConfig(**kw),
                            params=fam["variables"]["params"])
    _, got = phiseg_objective(got_out, torch.from_numpy(fam["s_oh"]), ExperimentConfig(**kw),
                              model=tmod)
    assert sorted(got) == sorted(want)
    assert ("KL_divergence_loss_lvl0" in got) == (fam["name"] != "det_unet")
    assert not any(k.startswith("KL") and k != "KL_divergence_loss_lvl0" for k in got)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-4, err_msg=k)


def _sampler_eps(m, key, n):
    """Per level (S, *z shape): draw s is the prior draw of key s of
    split(key, S), the keys JAX's make_sample_fn decodes (decode_sample's
    heads consume the key as prior_draw's do)."""
    per_draw = []
    for k in jax.random.split(key, n):
        z, mu, sigma = m["jmod"].apply(m["variables"], jnp.asarray(m["x"]), k,
                                       method="prior_draw")
        per_draw.append(_eps(z, mu, sigma))
    return [torch.stack([d[i] for d in per_draw]) for i in range(len(per_draw[0]))]


@pytest.mark.parametrize("return_probs", [True, False])
def test_make_sample_fn_matches_jax(fam, return_probs):
    key = jax.random.PRNGKey(6)
    want = jax_make_sample_fn(fam["jmod"], S, return_probs=return_probs)(
        fam["variables"], jnp.asarray(fam["x"]), key)
    eps = _sampler_eps(fam, key, S)
    got = make_sample_fn(fam["tmod"], S, return_probs=return_probs)(
        torch.from_numpy(fam["x"]), eps=eps)
    _close([got], [want], "samples", EVAL_TOL)
    if fam["name"] == "det_unet":  # S identical draws, no noise
        assert eps == []
        assert all(torch.equal(got[0], got[i]) for i in range(S))
    else:
        assert not torch.equal(got[0], got[1])


def test_decode_sample_levels_and_decode_z_match_jax(fam):
    m = fam
    key = jax.random.PRNGKey(7)
    want = jax_make_sample_levels_fn(m["jmod"], S)(m["variables"], jnp.asarray(m["x"]), key)
    got = make_sample_levels_fn(m["tmod"], S)(torch.from_numpy(m["x"]),
                                              eps=_sampler_eps(m, key, S))
    _close(got, want, "sample levels", EVAL_TOL)
    cache = m["jmod"].apply(m["variables"], jnp.asarray(m["x"]), method="sample_cache")
    want_one = m["jmod"].apply(m["variables"], cache, key, method="decode_sample")
    eps = None  # the one draw of `key` itself
    if m["name"] != "det_unet":
        eps = _eps(*m["jmod"].apply(m["variables"], jnp.asarray(m["x"]), key,
                                    method="prior_draw"))
    with torch.no_grad():
        got_one = m["tmod"].decode_sample(m["tmod"].sample_cache(torch.from_numpy(m["x"])),
                                          eps=eps)
    _close(got_one, want_one, "decode_sample", EVAL_TOL)

    post = m["jmod"].apply(m["variables"], jnp.asarray(m["x"]), jnp.asarray(m["s_oh"]),
                           jax.random.PRNGKey(8), method="posterior_draw")
    want_z = m["jmod"].apply(m["variables"], post[0], jnp.asarray(m["x"]), method="decode_z")
    with torch.no_grad():
        got_z = m["tmod"].decode_z([torch.from_numpy(np.array(t)) for t in post[0]],
                                   torch.from_numpy(m["x"]))
    _close(got_z, want_z, "decode_z", EVAL_TOL)


def test_inference_engine_latent_access(fam):
    """generate_prior/posterior_samples and generate_samples_from_z; empty
    tuples for the deterministic U-Net, as JAX returns."""
    m = fam
    cfg = ExperimentConfig(model_family=FAMILIES[m["name"]]["model_family"],
                           latent_levels=1, zdim0=m["kw"]["zdim0"], resolution_levels=5, n0=4,
                           image_size=(32, 32, 1), compute_dtype="float32")
    eng = InferenceEngine(cfg, m["tmod"])
    key = jax.random.PRNGKey(9)
    want = m["jmod"].apply(m["variables"], jnp.asarray(m["x"]), key, method="prior_draw")
    got = eng.generate_prior_samples(m["x"], return_params=True, eps=_eps(*want))
    post_want = m["jmod"].apply(m["variables"], jnp.asarray(m["x"]), jnp.asarray(m["s_oh"]),
                                key, method="posterior_draw")
    post = eng.generate_posterior_samples(m["x"], m["s"], return_params=True,
                                          eps=_eps(*post_want))
    for what, g, w in zip(("z", "mu", "sigma"), got + post, want + post_want):
        _close(g, w, what, EVAL_TOL)
    if m["name"] == "det_unet":
        assert got == post == ((), (), ()) and eng.generate_prior_samples(m["x"]) == ()
    want_agg = m["jmod"].apply(m["variables"], want[0], jnp.asarray(m["x"]), method="decode_z")
    got_agg = eng.generate_samples_from_z([np.array(t) for t in want[0]], m["x"])
    _close([got_agg], [want_agg[0]], "generate_samples_from_z", EVAL_TOL)


def test_make_validation_fn_matches_jax(fam):
    """Validation of each family with JAX's noise: the prior draws, and the
    ELBO's eval-forward draws (none for the deterministic U-Net)."""
    m = fam
    b = m["x"].shape[0]
    rng = np.random.RandomState(1)
    ann = (rng.rand(b, 4, 32, 32) > np.array([0.4, 0.5, 0.6, 0.7])[None, :, None, None]
           ).astype(np.int32)
    s_sel = ann[:, 1]
    kw = dict(model_family=FAMILIES[m["name"]]["model_family"], latent_levels=1,
              zdim0=m["kw"]["zdim0"], resolution_levels=5, n0=4, image_size=(32, 32, 1),
              compute_dtype="float32", validation_samples=S, validation_elbo_samples=2)
    key = jax.random.PRNGKey(11)
    want = jax_make_validation_fn(m["jmod"], JaxConfig(**kw))(
        m["variables"], jnp.asarray(m["x"]), jnp.asarray(ann), jnp.asarray(s_sel), key)
    k_samples, k_elbo = jax.random.split(key)
    eps_elbo = []
    for k in jax.random.split(k_elbo, 2):
        out = m["jmod"].apply(m["variables"], jnp.asarray(m["x"]),
                              jax.nn.one_hot(jnp.asarray(s_sel), 2), k, train=False)
        eps_elbo.append(_eps(out.z, out.q_mu, out.q_sigma))
    eps_elbo = [torch.stack([d[i] for d in eps_elbo]) for i in range(len(eps_elbo[0]))]
    got = make_validation_fn(m["tmod"], ExperimentConfig(**kw))(
        torch.from_numpy(m["x"]), torch.from_numpy(ann), torch.from_numpy(s_sel),
        eps_samples=_sampler_eps(m, k_samples, S), eps_elbo=eps_elbo)
    for what, g, w in zip(("dice", "ged", "sncc", "elbo"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=what, **EVAL_TOL)


def _cache_as_each_decode_reads_it(model, x, n):
    """The sampling cache of x for n draws an image, tiled as each family's
    decode reads it: PHiSeg's prior encoder levels from R-L on (None below)
    and its likelihood's empty cache; the Probabilistic U-Net's prior
    (mu, sigma) and its likelihood's U-Net features; every level of the
    HPU-Net prior's encoder features; SSN's (mu, W, D) of the B images,
    untiled (its decode broadcasts them over the draws)."""
    x_c = x.permute(0, 3, 1, 2)
    if model.model_family == "ssn":
        return model.likelihood(x_c)
    if model.model_family == "phiseg":
        feats = model.prior.tower(x_c.to(model.dtype))
        d = model.likelihood.lvl_diff
        return tuple(None if i < d else t.repeat(n, 1, 1, 1) for i, t in enumerate(feats)), ()
    if model.model_family == "prob_unet":
        return (tuple(t.repeat(n, 1) for t in model.prior.encode(x_c)),
                model.likelihood.features(x_c).repeat(n, 1, 1, 1))
    return tuple(t.repeat(n, 1, 1, 1) for t in model.prior.encode(x_c))


def _assert_same_cache(got, want, where="cache"):
    if want is None or isinstance(want, torch.Tensor):
        assert (got is None) if want is None else torch.equal(got, want), where
        return
    assert isinstance(got, tuple) and len(got) == len(want), where
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same_cache(g, w, f"{where}[{i}]")


@pytest.mark.parametrize("name", sorted(list_experiments()))
def test_every_registry_entry_builds(name):
    """No entry of the registry raises; each builds the JAX entry's model
    family with its latent levels, and its sampler tiles the cache its
    decode reads (the deterministic U-Net's sampler does not tile)."""
    from phiseg_tpu_torch.engine.train import build_model

    cfg = get_experiment(name)
    model = build_model(cfg.replace(n0=2), device="cpu")
    assert model.model_family == cfg.model_family
    assert len(model.latent_shapes(3)) == (cfg.effective_latent_levels if model.has_latents else 0)
    if model.has_latents:
        x = torch.randn(1, *cfg.image_size, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.eval()
            _assert_same_cache(model.repeat_cache(model.sample_cache(x), 2),
                               _cache_as_each_decode_reads_it(model, x, 2))


# -- the CLIs on the CPU at a tiny size --------------------------------------

TINY = dict(resolution_levels=4, n0=2, image_size=(16, 16, 1), compute_dtype="float32",
            norm="batch", batch_size=4, data_identifier="synthetic", synth_n_train=8,
            synth_n_val=4, synth_n_test=5, validation_frequency=1, validation_samples=3,
            validation_elbo_samples=2, tensorboard_update_frequency=1,
            do_image_summaries=False, do_histogram_summaries=False)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A log dir per family through the train CLI: 3 steps, validating at
    steps 1 and 2."""
    root = tmp_path_factory.mktemp("families")
    dirs = {}
    for name, kw in (("phiseg", dict(latent_levels=2, zdim0=2)),
                     ("prob_unet", dict(latent_levels=1, zdim0=6)),
                     ("det_unet", dict(latent_levels=1, zdim0=6, annotator_range=(0,),
                                       kl_divergence_loss_weight=None))):
        cfg = ExperimentConfig(experiment_name=name, model_family=name, **kw, **TINY)
        path = str(root / f"{name}.json")
        cfg.save(path)
        log_dir = str(root / name)
        train_main([path, "--num-iter", "3", "--log-dir", log_dir, "--device", "cpu"])
        dirs[name] = log_dir
    return dirs


@pytest.mark.parametrize("family", ["phiseg", "prob_unet", "det_unet"])
def test_train_cli_trains_validates_and_keeps_the_best(trained, family):
    log_dir = trained[family]
    recs = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    train = [r for r in recs if "batch_total_loss" in r]
    val = [r for r in recs if "validation_GED" in r]
    assert [r["step"] for r in train] == [0, 1, 2] and len(val) == 2
    assert all(np.isfinite(v) for r in recs for v in r.values() if isinstance(v, float))
    levels = {"phiseg": 2, "prob_unet": 1, "det_unet": 0}[family]
    assert sorted(k for k in train[0] if "KL_divergence" in k) == [
        f"batch_KL_divergence_loss_lvl{i}" for i in range(levels)]
    for tag in ("latest", "best_dice", "best_loss", "best_ged", "best_ncc"):
        assert CheckpointManager(log_dir).has_checkpoint(tag), tag


@pytest.mark.parametrize("family", ["phiseg", "prob_unet", "det_unet"])
def test_test_predictions_writes_the_npz_contract(trained, family):
    log_dir = trained[family]
    dice = pred_main([log_dir, "--samples", "4", "--batch", "2", "--device", "cpu"])
    with np.load(os.path.join(log_dir, "dice_best_dice.npz")) as z:
        assert list(z.keys()) == ["arr_0"]
        np.testing.assert_array_equal(z["arr_0"], dice)
    assert dice.shape == (5, 2) and np.isfinite(dice).all()
    assert ((dice >= 0) & (dice <= 1)).all()
    ged, ncc = quant_main([log_dir, "--samples", "3", "--batch", "2", "--device", "cpu"])
    assert ged.shape == ncc.shape == (5,) and np.isfinite(ged).all() and np.isfinite(ncc).all()


def test_test_predictions_options(trained):
    log_dir = trained["prob_unet"]
    dice = pred_main([log_dir, "--samples", "2", "--tag", "best_ged", "--max-images", "3",
                      "--synth-n-test", "9", "--device", "cpu"])
    assert dice.shape == (3, 2)
    assert os.path.exists(os.path.join(log_dir, "dice_best_ged.npz"))
    assert pred_main([log_dir, "--samples", "2", "--synth-n-test", "9",
                      "--device", "cpu"]).shape == (9, 2)


def test_det_unet_dice_equals_jax(tmp_path):
    """The deterministic U-Net's test_predictions Dice: the port CLI on a
    log dir holding converted JAX weights vs JAX's dice_per_label of the JAX
    model's argmax, on the same test images and annotator picks (one draw,
    forced, whatever --samples says)."""
    kw = dict(model_family="det_unet", latent_levels=1, zdim0=6, resolution_levels=5, n0=4,
              image_size=(32, 32, 1), compute_dtype="float32", data_identifier="synthetic",
              synth_n_test=5, annotator_range=(0, 1, 2, 3))
    cfg = ExperimentConfig(**kw)
    jmod = JaxSegVAE(**dict(FAMILIES["det_unet"], **COMMON))
    x0 = jnp.zeros((2, 32, 32, 1))
    shapes = jax.eval_shape(lambda k: jmod.init({"params": k}, x0, jnp.zeros((2, 32, 32, 2)), k,
                                                train=True), jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map_with_path(_fill(np.random.RandomState(3)), shapes)
    state = create_train_state(cfg, device="cpu")
    state.model.load_state_dict(flax_to_state_dict(variables, state.model))
    cfg.save(str(tmp_path / "config.json"))
    CheckpointManager(str(tmp_path)).save(state, "best_dice", step=3)

    got = pred_main([str(tmp_path), "--samples", "7", "--batch", "2", "--device", "cpu"])
    data = get_dataset(cfg)
    host_rng = np.random.RandomState(cfg.seed)
    sample = jax_make_sample_fn(jmod, 1)
    want = []
    for b0 in range(0, 5, 2):
        x = np.asarray(data.test.images[b0:b0 + 2]).astype(np.float32)[..., None]
        ann = np.asarray(data.test.labels[b0:b0 + 2]).astype(np.int32)
        picks = host_rng.choice(list(cfg.annotator_range), size=x.shape[0])
        s_sel = np.stack([ann[i, :, :, a] for i, a in enumerate(picks)], 0)
        probs = sample(variables, jnp.asarray(x), jax.random.PRNGKey(0))
        want.append(np.asarray(jax_dice_per_label(jnp.argmax(probs.mean(0), -1),
                                                  jnp.asarray(s_sel), 2)))
    np.testing.assert_allclose(got, np.concatenate(want), rtol=0, atol=1e-6)
