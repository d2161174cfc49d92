"""The port's SegVAE training forward vs phiseg_tpu's SegVAE.apply on the CPU.

The JAX model is initialised by flax; its weights go to the port through
phiseg_tpu_torch.convert, its batch statistics are made non-trivial, and the
posterior noise is injected into the port as eps = (z - mu) / sigma from the
JAX forward (threefry draws cannot be reproduced in torch). Everything runs
in f32. Tolerance rtol 1e-3 / atol 1e-3 (of O(1..10) values): twenty-odd
convolutions and batch norms in a chain each sum in another order, and
train-mode batch norm at the coarsest level normalises over only 8 values
per channel, which magnifies that round-off (measured: 1.4e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiseg_tpu.models import SegVAE as JaxSegVAE
from phiseg_tpu_torch.convert import flax_to_state_dict
from phiseg_tpu_torch.models import SegVAE, aggregate_levels, default_channels

torch.set_num_threads(1)
TOL = dict(rtol=1e-3, atol=1e-3)


def _setup(R, L, hw, n0, seed=0, b=2):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, hw, hw, 1).astype(np.float32)
    s_oh = np.eye(2, dtype=np.float32)[(rng.rand(b, hw, hw) > 0.6).astype(np.int64)]
    kw = dict(model_family="phiseg", latent_levels=L, resolution_levels=R, n0=n0, zdim0=2,
              nlabels=2, image_size=(hw, hw), norm="batch")
    jmod = JaxSegVAE(**kw)
    key = jax.random.PRNGKey(seed)
    # The tree's structure from flax without compiling its init; the values
    # from numpy: he-scaled kernels, and non-trivial biases, BN scales and
    # running statistics, so the eval mode is tested too.
    shapes = jax.eval_shape(lambda k, a, s: jmod.init({"params": k}, a, s, k, train=True),
                            key, jnp.asarray(x), jnp.asarray(s_oh))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)  # scale, mean, var

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    tmod = SegVAE(**kw, dtype=torch.float32, image_channels=1)
    tmod.load_state_dict(flax_to_state_dict(variables, tmod))
    return x, s_oh, jmod, variables, tmod, key


def _compare(R, L, hw, n0, train):
    x, s_oh, jmod, variables, tmod, key = _setup(R, L, hw, n0)
    apply = jax.jit(lambda v, a, s, k: jmod.apply(v, a, s, k, train=train,
                                                  mutable=["batch_stats"] if train else False))
    res = apply(variables, jnp.asarray(x), jnp.asarray(s_oh), key)
    out, mutated = res if train else (res, None)
    eps = [torch.from_numpy((np.asarray(z) - np.asarray(m)) / np.asarray(s))
           for z, m, s in zip(out.z, out.q_mu, out.q_sigma)]
    tmod.train(train)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(s_oh), eps=eps)
    for field in ("s_out_list", "z", "q_mu", "q_sigma", "p_mu", "p_sigma"):
        want_t, got_t = getattr(out, field), getattr(got, field)
        assert len(want_t) == len(got_t) == L
        for i, (w, g) in enumerate(zip(want_t, got_t)):
            assert tuple(g.shape) == w.shape, (field, i)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"{field}[{i}]", **TOL)
    if train:
        want_stats = flax_to_state_dict({"batch_stats": mutated["batch_stats"],
                                         "params": variables["params"]}, tmod)
        for name, t in tmod.state_dict().items():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(t.numpy(), want_stats[name].numpy(), err_msg=name,
                                           **TOL)


@pytest.mark.parametrize("train", [True, False])
def test_segvae_forward_matches_jax_r5_l3(train):
    _compare(R=5, L=3, hw=32, n0=4, train=train)


def test_segvae_forward_matches_jax_r7_l5_structure():
    """The flagship's structure (R=7, L=5) at 64x64 and n0=2, in eval BN
    mode: in train mode its 1x1 coarsest level normalises over 2 values per
    channel, which magnifies f32 round-off past any useful tolerance."""
    _compare(R=7, L=5, hw=64, n0=2, train=False)


def test_state_dict_names_are_flax_scopes():
    m = SegVAE(latent_levels=3, resolution_levels=5, n0=4, image_size=(32, 32))
    names = set(m.state_dict())
    for n in ("posterior.tower.level0_conv0.conv.weight",
              "posterior.tower.level0_conv0.bn.running_var",
              "prior.hierarchy.z2_head.mu.conv.weight",
              "posterior.hierarchy.z0_ups_conv1.bn.weight",
              "likelihood.post_c0_merge1.conv.weight",
              "likelihood.out2.conv.bias"):
        assert n in names, n
    # the 3x3 mu head at the coarsest latent level, 1x1 elsewhere
    assert m.posterior.hierarchy.z2_head.mu.conv.weight.shape[-1] == 3
    assert m.posterior.hierarchy.z1_head.mu.conv.weight.shape[-1] == 1
    # merge convs carry ch[i + R - L] channels (families.py:170-173)
    ch = default_channels(4, 5)
    assert m.likelihood.post_c0_merge0.conv.weight.shape[0] == ch[0 + 2]


def test_converter_raises_on_unmapped_leaves():
    x, s_oh, jmod, variables, tmod, key = _setup(R=5, L=3, hw=32, n0=4)
    extra = {"params": dict(variables["params"]), "batch_stats": variables["batch_stats"]}
    extra["params"]["stray"] = {"conv": {"kernel": np.zeros((1, 1, 1, 1), np.float32)}}
    with pytest.raises(KeyError, match="does not have"):
        flax_to_state_dict(extra, tmod)
    short = {"params": variables["params"]}  # no batch_stats -> model entries left empty
    with pytest.raises(KeyError, match="no Flax leaf"):
        flax_to_state_dict(short, tmod)


@pytest.mark.parametrize("family", ["phiseg", "prob_unet", "det_unet"])
def test_segvae_size_check_and_every_family_builds(family):
    """Each family keeps the size check, builds, and its state_dict names are
    exactly the Flax scopes of the JAX model's tree (the converter maps
    every leaf and leaves no entry empty)."""
    with pytest.raises(ValueError, match="too small"):
        SegVAE(model_family=family, resolution_levels=7, image_size=(32, 32))
    kw = dict(model_family=family, latent_levels=2, resolution_levels=5, n0=4, zdim0=6,
              nlabels=2, image_size=(32, 32), norm="batch")
    m = SegVAE(**kw)
    jmod = JaxSegVAE(**kw)
    x = jnp.zeros((2, 32, 32, 1))
    shapes = jax.eval_shape(lambda k: jmod.init({"params": k}, x, jnp.zeros((2, 32, 32, 2)), k,
                                                train=True), jax.random.PRNGKey(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    assert set(flax_to_state_dict(zeros, m)) == set(m.state_dict())
    assert m.has_latents == (family != "det_unet")
    if family == "phiseg":
        return
    # U-Net decoder convs carry the deeper level's channels (ch = 4, 8, 16,
    # 24, 24), and the 1x1 head takes the last step's ch[1] (+ zdim0 = 6)
    unet = m.likelihood.unet
    assert unet.dec0_conv0.conv.weight.shape[:2] == (24, 24 + 24)
    assert unet.dec1_conv0.conv.weight.shape[:2] == (24, 24 + 16)
    assert unet.dec3_conv0.conv.weight.shape[:2] == (8, 16 + 4)
    extra = 6 if family == "prob_unet" else 0
    assert m.likelihood.recomb0.conv.weight.shape[:2] == (4, 8 + extra)


def test_aggregate_levels_sums_the_levels():
    a, b, c = torch.ones(2), torch.full((2,), 2.0), torch.full((2,), 3.0)
    assert torch.equal(aggregate_levels([a, b, c]), torch.full((2,), 6.0))


@pytest.mark.parametrize("package", ["engine", "models"])
def test_package_exports_what_jax_exports(package):
    """phiseg_tpu_torch.engine and .models export phiseg_tpu.engine's and
    .models' names, each defined."""
    import importlib

    jax_pkg = importlib.import_module(f"phiseg_tpu.{package}")
    port_pkg = importlib.import_module(f"phiseg_tpu_torch.{package}")
    assert port_pkg.__all__ == jax_pkg.__all__
    assert all(hasattr(port_pkg, n) for n in port_pkg.__all__)
