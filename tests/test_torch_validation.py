"""The port's validation, quantitative-eval and eval-loss functions vs
phiseg_tpu's on the CPU.

Both sides hold the same weights (flax variables converted by
phiseg_tpu_torch.convert) with batch statistics far from (0, 1), since all
three run in eval batch-norm mode, and everything runs in f32. JAX draws
with threefry, so the port is given JAX's own noise: eps = (z - mu) / sigma
of `prior_draw` with each sample key (whose heads consume the key as
`decode_sample` does), and of the eval forward with each ELBO key.

Tolerances: probabilities and losses rtol 1e-4 / atol 1e-4, as the sampler's
test (about twenty convolutions summed in another order). The masks are the
argmax of those probabilities, so a pixel may differ only at a near-tie
(|p1 - p0| < 1e-5); with these seeds none does, and the mask-derived Dice
and GED^2 then agree to f32 round-off (rtol 1e-5). S_NCC reads log(p) of
every draw, rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiseg_tpu.engine.config import ExperimentConfig as JaxConfig
from phiseg_tpu.engine.train import build_model as jax_build_model
from phiseg_tpu.engine.train import make_eval_loss_fn as jax_make_eval_loss_fn
from phiseg_tpu.engine.train import make_sample_fn as jax_make_sample_fn
from phiseg_tpu.engine.validation import make_quant_eval_fn as jax_make_quant_eval_fn
from phiseg_tpu.engine.validation import make_validation_fn as jax_make_validation_fn
from phiseg_tpu_torch.convert import flax_to_state_dict
from phiseg_tpu_torch.engine import objective
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.train import build_model, make_eval_loss_fn
from phiseg_tpu_torch.engine.validation import make_quant_eval_fn, make_validation_fn

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
MASK_TOL = dict(rtol=1e-5, atol=1e-6)
TIE = 1e-5
B, M, S, E = 3, 4, 5, 3
CFG = dict(model_family="phiseg", latent_levels=3, resolution_levels=5, n0=4, zdim0=2,
           image_size=(32, 32, 1), compute_dtype="float32", norm="batch", batch_size=B,
           validation_samples=S, validation_elbo_samples=E)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    x = rng.randn(B, 32, 32, 1).astype(np.float32)
    # annotators that disagree: thresholds of one smooth field, plus noise
    field = np.cumsum(rng.randn(B, 32, 32), axis=2) / 4
    ann = np.stack([(field + 0.3 * rng.randn(B, 32, 32)) > t for t in (-0.5, 0, 0.3, 0.6)],
                   axis=1).astype(np.int32)  # (B,M,H,W)
    ann[0, 1] = 0  # an empty annotation
    s_sel = ann[np.arange(B), rng.randint(0, M, B)]
    jcfg = JaxConfig(**CFG)
    jmod = jax_build_model(jcfg)
    s_oh = jax.nn.one_hot(jnp.asarray(s_sel), 2)
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
    tmod = build_model(tcfg, device="cpu")
    tmod.load_state_dict(flax_to_state_dict(variables, tmod))
    return dict(x=x, ann=ann, s_sel=s_sel, jcfg=jcfg, jmod=jmod, variables=variables,
                tcfg=tcfg, tmod=tmod)


def _eps(draw):
    z, mu, sigma = draw
    return [torch.from_numpy((np.asarray(a) - np.asarray(m)) / np.asarray(sg))
            for a, m, sg in zip(z, mu, sigma)]


def _stack(per_draw):
    """Per level (K, B, h, w, zdim) from K per-draw lists."""
    return [torch.stack([d[i] for d in per_draw]) for i in range(len(per_draw[0]))]


def _sample_eps(m, key, n):
    """The noise of JAX's sampler with `key`: draw k is the prior draw of
    key k of split(key, n)."""
    return _stack([_eps(m["jmod"].apply(m["variables"], jnp.asarray(m["x"]), k,
                                        method="prior_draw"))
                   for k in jax.random.split(key, n)])


def _forward_eps(m, key, s):
    out = m["jmod"].apply(m["variables"], jnp.asarray(m["x"]),
                          jax.nn.one_hot(jnp.asarray(s), 2), key, train=False)
    return _eps((out.z, out.q_mu, out.q_sigma))


def _masks_agree_but_at_ties(m, key, n, got_probs=None):
    """JAX's and the port's sample masks for `key`: equal except at near-ties.
    Returns the number of pixels that differ."""
    want = np.asarray(jax_make_sample_fn(m["jmod"], n)(m["variables"], jnp.asarray(m["x"]),
                                                       key))
    diff = want.argmax(-1) != got_probs.numpy().argmax(-1)
    margin = np.abs(want[..., 1] - want[..., 0])
    assert (margin[diff] < TIE).all(), margin[diff]
    return int(diff.sum())


def test_make_validation_fn_matches_jax(setup):
    m = setup
    key = jax.random.PRNGKey(11)
    want = jax_make_validation_fn(m["jmod"], m["jcfg"])(
        m["variables"], jnp.asarray(m["x"]), jnp.asarray(m["ann"]), jnp.asarray(m["s_sel"]), key)
    k_samples, k_elbo = jax.random.split(key)
    eps_samples = _sample_eps(m, k_samples, S)
    eps_elbo = _stack([_forward_eps(m, k, m["s_sel"]) for k in jax.random.split(k_elbo, E)])
    got = make_validation_fn(m["tmod"], m["tcfg"])(
        torch.from_numpy(m["x"]), torch.from_numpy(m["ann"]), torch.from_numpy(m["s_sel"]),
        eps_samples=eps_samples, eps_elbo=eps_elbo)

    from phiseg_tpu_torch.engine.train import make_sample_fn

    probs = make_sample_fn(m["tmod"], S)(torch.from_numpy(m["x"]), eps=eps_samples)
    assert _masks_agree_but_at_ties(m, k_samples, S, probs) == 0

    dice, ged, sncc, elbo = got
    assert dice.shape == (B, 2) and ged.shape == (B,) and sncc.shape == (B,)
    assert elbo.shape == () and all(t.dtype == torch.float32 for t in got)
    np.testing.assert_allclose(dice.numpy(), np.asarray(want[0]), **MASK_TOL)
    np.testing.assert_allclose(ged.numpy(), np.asarray(want[1]), **MASK_TOL)
    np.testing.assert_allclose(sncc.numpy(), np.asarray(want[2]), **TOL)
    np.testing.assert_allclose(float(elbo), float(want[3]), **TOL)
    assert np.isfinite(sncc.numpy()).all() and (ged.numpy() > 0).all()


def test_make_quant_eval_fn_matches_jax(setup):
    m = setup
    key = jax.random.PRNGKey(12)
    want = jax_make_quant_eval_fn(m["jmod"], m["jcfg"], S)(
        m["variables"], jnp.asarray(m["x"]), jnp.asarray(m["ann"]), key)
    eps = _sample_eps(m, key, S)
    ged, sncc, terms = make_quant_eval_fn(m["tmod"], m["tcfg"], S)(
        torch.from_numpy(m["x"]), torch.from_numpy(m["ann"]), eps=eps)
    from phiseg_tpu_torch.engine.train import make_sample_fn

    probs = make_sample_fn(m["tmod"], S)(torch.from_numpy(m["x"]), eps=eps)
    assert _masks_agree_but_at_ties(m, key, S, probs) == 0
    assert terms.shape == (B, 3)
    np.testing.assert_allclose(ged.numpy(), np.asarray(want[0]), **MASK_TOL)
    np.testing.assert_allclose(sncc.numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_allclose(terms.numpy(), np.asarray(want[2]), **MASK_TOL)
    np.testing.assert_allclose((2 * terms[:, 0] - terms[:, 1] - terms[:, 2]).numpy(),
                               ged.numpy(), rtol=1e-6)


def test_make_eval_loss_fn_matches_jax(setup):
    m = setup
    key = jax.random.PRNGKey(13)
    want = jax_make_eval_loss_fn(m["jmod"], m["jcfg"])(
        m["variables"], jnp.asarray(m["x"]), jnp.asarray(m["s_sel"]), key)
    tmod = m["tmod"]
    tmod.train()  # the function switches to eval mode and back
    stats = {k: v.clone() for k, v in tmod.state_dict().items() if "running" in k}
    got = make_eval_loss_fn(tmod, m["tcfg"])(torch.from_numpy(m["x"]),
                                             torch.from_numpy(m["s_sel"]),
                                             eps=_forward_eps(m, key, m["s_sel"]))
    assert tmod.training
    assert all(torch.equal(v, tmod.state_dict()[k]) for k, v in stats.items())
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert not v.requires_grad
        np.testing.assert_allclose(float(v), float(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("rule,calls", [(None, 0), (True, 1), (False, 0)])
def test_the_fused_rule_puts_k1_on_the_validation_path(setup, monkeypatch, rule, calls):
    """use_fused_loss_kernel None means on the card, so on the CPU the plain
    CE runs; True sends every ELBO draw and each eval-loss call through
    fused_residual_ce (whose CPU tensors take its plain version)."""
    m = setup
    seen = []

    def counting(logits, s_oh):
        seen.append(len(logits))
        return objective.residual_ce_plain(logits, s_oh)

    monkeypatch.setattr(objective, "fused_residual_ce", counting)
    cfg = m["tcfg"].replace(use_fused_loss_kernel=rule)
    g = torch.Generator().manual_seed(0)
    x, ann, s = (torch.from_numpy(m[k]) for k in ("x", "ann", "s_sel"))
    losses = make_eval_loss_fn(m["tmod"], cfg)(x, s, g)
    assert len(seen) == calls
    dice, ged, sncc, elbo = make_validation_fn(m["tmod"], cfg)(x, ann, s, g)
    assert len(seen) == calls * (1 + E)
    assert seen == [cfg.latent_levels] * len(seen)
    assert torch.isfinite(elbo) and torch.isfinite(losses["total_loss"])


def test_validation_draws_from_its_generator(setup):
    m = setup
    x, ann, s = (torch.from_numpy(m[k]) for k in ("x", "ann", "s_sel"))
    validate = make_validation_fn(m["tmod"], m["tcfg"])
    a = validate(x, ann, s, torch.Generator().manual_seed(0))
    b = validate(x, ann, s, torch.Generator().manual_seed(0))
    c = validate(x, ann, s, torch.Generator().manual_seed(1))
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert not torch.equal(a[3], c[3])
    assert ((a[0] >= 0) & (a[0] <= 1)).all()
    quant = make_quant_eval_fn(m["tmod"], m["tcfg"], 7)
    ged, sncc, terms = quant(x, ann, torch.Generator().manual_seed(0))
    assert ged.shape == sncc.shape == (B,) and terms.shape == (B, 3)
    assert torch.isfinite(ged).all() and torch.isfinite(sncc).all()
