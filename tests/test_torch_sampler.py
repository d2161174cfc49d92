"""The port's prior sampler and SegVAE sampling methods vs phiseg_tpu on the CPU.

The JAX model's weights go to the port through phiseg_tpu_torch.convert,
with non-trivial batch statistics, since sampling runs in eval batch-norm
mode. JAX draws its noise with threefry, which torch cannot reproduce, so the
port is given eps = (z - mu) / sigma of the JAX draw with the same key: for
the prior from `prior_draw`, whose heads consume the same key as
`decode_sample`'s. Everything runs in f32; tolerance rtol 1e-4 / atol 1e-4
(of O(1..10) values): about twenty convolutions in a chain sum in another
order.

The sharded sampler runs on two gloo ranks, spawned once for the module
with a timeout of 120 s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiseg_tpu.engine.train import make_sample_fn as jax_make_sample_fn
from phiseg_tpu.engine.train import make_sample_levels_fn as jax_make_sample_levels_fn
from phiseg_tpu.models import SegVAE as JaxSegVAE
from phiseg_tpu_torch.convert import flax_to_state_dict
from phiseg_tpu_torch.engine.train import make_sample_fn, make_sample_levels_fn
from phiseg_tpu_torch.models import SegVAE
from phiseg_tpu_torch.parallel import make_mesh, make_sharded_sample_fn, spawn_ranks

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
KW = dict(model_family="phiseg", latent_levels=3, resolution_levels=5, n0=4, zdim0=2,
          nlabels=2, image_size=(32, 32), norm="batch")
S = 4


@pytest.fixture(scope="module")
def models():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 1).astype(np.float32)
    s_oh = np.eye(2, dtype=np.float32)[(rng.rand(2, 32, 32) > 0.6).astype(np.int64)]
    jmod = JaxSegVAE(**KW)
    shapes = jax.eval_shape(lambda k: jmod.init({"params": k}, jnp.asarray(x), jnp.asarray(s_oh),
                                                k, train=True), jax.random.PRNGKey(0))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*leaf.shape) * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)  # scale, var

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    tmod = SegVAE(**KW, dtype=torch.float32, image_channels=1)
    tmod.load_state_dict(flax_to_state_dict(variables, tmod))
    tmod.eval()
    return dict(x=x, s_oh=s_oh, jmod=jmod, variables=variables, tmod=tmod)


def _eps(draw):
    z, mu, sigma = draw
    return [torch.from_numpy((np.asarray(a) - np.asarray(m)) / np.asarray(sg))
            for a, m, sg in zip(z, mu, sigma)]


def _prior_eps(m, key):
    return _eps(m["jmod"].apply(m["variables"], jnp.asarray(m["x"]), key, method="prior_draw"))


def _close(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == np.shape(w), (what, i)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"{what}[{i}]", **TOL)


def test_decode_sample_with_prior_draw_eps_matches_jax(models):
    m = models
    key = jax.random.PRNGKey(3)
    cache = m["jmod"].apply(m["variables"], jnp.asarray(m["x"]), method="sample_cache")
    want = m["jmod"].apply(m["variables"], cache, key, method="decode_sample")
    with torch.no_grad():
        got = m["tmod"].decode_sample(m["tmod"].sample_cache(torch.from_numpy(m["x"])),
                                      eps=_prior_eps(m, key))
    _close(got, want, "decode_sample")
    want_agg = m["jmod"].apply(m["variables"], jnp.asarray(m["x"]), key, method="sample_logits")
    with torch.no_grad():
        got_agg = m["tmod"].sample_logits(torch.from_numpy(m["x"]), eps=_prior_eps(m, key))
    _close([got_agg], [want_agg], "sample_logits")


def test_prior_draw_matches_jax(models):
    m = models
    key = jax.random.PRNGKey(4)
    want = m["jmod"].apply(m["variables"], jnp.asarray(m["x"]), key, method="prior_draw")
    with torch.no_grad():
        got = m["tmod"].prior_draw(torch.from_numpy(m["x"]), eps=_eps(want))
    for what, g, w in zip(("z", "mu", "sigma"), got, want):
        _close(g, w, f"prior {what}")


def test_posterior_draw_and_decode_z_match_jax(models):
    m = models
    key = jax.random.PRNGKey(5)
    want = m["jmod"].apply(m["variables"], jnp.asarray(m["x"]), jnp.asarray(m["s_oh"]), key,
                           method="posterior_draw")
    with torch.no_grad():
        got = m["tmod"].posterior_draw(torch.from_numpy(m["x"]), torch.from_numpy(m["s_oh"]),
                                       eps=_eps(want))
    for what, g, w in zip(("z", "mu", "sigma"), got, want):
        _close(g, w, f"posterior {what}")
    z = want[0]
    want_logits = m["jmod"].apply(m["variables"], z, jnp.asarray(m["x"]), method="decode_z")
    with torch.no_grad():
        got_logits = m["tmod"].decode_z([torch.from_numpy(np.array(t)) for t in z],
                                        torch.from_numpy(m["x"]))
    _close(got_logits, want_logits, "decode_z")


def _sampler_eps(m, key):
    """Per level (S, B, h, w, zdim): draw s is the prior draw of key s of
    jax.random.split(key, S), the keys JAX's make_sample_fn decodes."""
    per_draw = [_prior_eps(m, k) for k in jax.random.split(key, S)]
    return [torch.stack([d[i] for d in per_draw]) for i in range(len(per_draw[0]))]


@pytest.mark.parametrize("return_probs", [True, False])
def test_make_sample_fn_matches_jax(models, return_probs):
    m = models
    key = jax.random.PRNGKey(6)
    want = jax_make_sample_fn(m["jmod"], S, return_probs=return_probs)(
        m["variables"], jnp.asarray(m["x"]), key)
    got = make_sample_fn(m["tmod"], S, return_probs=return_probs)(
        torch.from_numpy(m["x"]), eps=_sampler_eps(m, key))
    _close([got], [want], "samples")


def test_make_sample_levels_fn_matches_jax(models):
    m = models
    key = jax.random.PRNGKey(7)
    want = jax_make_sample_levels_fn(m["jmod"], S)(m["variables"], jnp.asarray(m["x"]), key)
    got = make_sample_levels_fn(m["tmod"], S)(torch.from_numpy(m["x"]), eps=_sampler_eps(m, key))
    _close(got, want, "sample levels")


def test_sampler_draws_from_its_generator_in_eval_mode(models):
    m = models
    tmod = m["tmod"]
    tmod.train()  # the sampler switches to eval mode and back
    x = torch.from_numpy(m["x"])
    sample = make_sample_fn(tmod, 6)
    a = sample(x, torch.Generator().manual_seed(0))
    b = sample(x, torch.Generator().manual_seed(0))
    c = sample(x, torch.Generator().manual_seed(1))
    assert tmod.training
    tmod.eval()
    assert a.shape == (6, 2, 32, 32, 2) and a.dtype == torch.float32
    torch.testing.assert_close(a.sum(-1), torch.ones(6, 2, 32, 32))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])  # the draws differ
    stats = {k: v.clone() for k, v in tmod.state_dict().items() if "running" in k}
    sample(x, torch.Generator().manual_seed(0))
    assert all(torch.equal(v, tmod.state_dict()[k]) for k, v in stats.items())


def _sharded_rank(state_dict, x):
    """The sharded sampler, probabilities and logits, on one rank (runs in
    a spawned process)."""
    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    tmod = SegVAE(**KW, dtype=torch.float32, image_channels=1)
    tmod.load_state_dict(state_dict)
    x = torch.from_numpy(x)
    out = {"probs": make_sample_fn(tmod, 8, mesh=mesh)(x, torch.Generator().manual_seed(0)),
           "logits": make_sample_fn(tmod, 8, return_probs=False, mesh=mesh)(
               x, torch.Generator().manual_seed(0)),
           # the JAX package's name for the same sampler
           "alias": make_sharded_sample_fn(tmod, 8, mesh)(x, torch.Generator().manual_seed(0))}
    try:
        make_sample_fn(tmod, 5, mesh=mesh)
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def test_sharded_sampler_equals_the_unsharded_one(models):
    """Each rank decodes 4 of the 8 draws, from the one noise tensor both
    draw from the same seed; eval-mode rows are independent, so the result
    is the unsharded one up to f32 round-off of a smaller batch."""
    m = models
    outs = spawn_ranks(_sharded_rank, 2, (m["tmod"].state_dict(), m["x"]), backend="gloo",
                       timeout=120)
    x = torch.from_numpy(m["x"])
    want = make_sample_fn(m["tmod"], 8)(x, torch.Generator().manual_seed(0))
    want_logits = make_sample_fn(m["tmod"], 8, return_probs=False)(
        x, torch.Generator().manual_seed(0))
    for o in outs:
        assert o["probs"].shape == (8, 2, 32, 32, 2)
        torch.testing.assert_close(o["probs"], want, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(o["logits"], want_logits, rtol=1e-5, atol=1e-5)
        assert "do not split" in o["uneven"]
        assert torch.equal(o["alias"], o["probs"])
    assert torch.equal(outs[0]["probs"], outs[1]["probs"])
