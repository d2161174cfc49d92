"""The port's conv block, pool and resizes vs phiseg_tpu.nn.layers on the CPU.

Inputs come from numpy with a seed; the JAX side runs NHWC, the port NCHW.
Tolerances are f32 round-off: the two frameworks sum convolutions and batch
statistics in other orders (rtol/atol 1e-5 on O(1) values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from phiseg_tpu.nn import layers as jl
from phiseg_tpu_torch.convert import flax_to_state_dict
from phiseg_tpu_torch.nn import layers as tl

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _pair(norm, activation, kernel=3, cin=3, cout=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 8, 8, cin).astype(np.float32)
    jmod = jl.ConvBlock(cout, kernel_size=(kernel, kernel), norm=norm,
                        activation={"relu": jax.nn.relu, "softplus": jax.nn.softplus,
                                    None: None}[activation])
    variables = jax.tree_util.tree_map(np.asarray,
                                       jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    variables = {k: dict(v) for k, v in variables.items()}
    if norm == "batch":  # make the BN state non-trivial
        variables["params"]["bn"] = {"scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
                                     "bias": rng.randn(cout).astype(np.float32)}
        variables["batch_stats"]["bn"] = {"mean": rng.randn(cout).astype(np.float32),
                                          "var": rng.uniform(0.5, 2, cout).astype(np.float32)}
    tmod = tl.ConvBlock(cin, cout, kernel_size=kernel, norm=norm,
                        activation={"relu": F.relu, "softplus": F.softplus, None: None}[activation])
    tmod.load_state_dict(flax_to_state_dict(variables, tmod))
    return x, jmod, variables, tmod


@pytest.mark.parametrize("train", [True, False])
def test_conv_block_batch_norm(train):
    x, jmod, variables, tmod = _pair("batch", "relu")
    if train:
        want, mutated = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want, mutated = jmod.apply(variables, jnp.asarray(x), train=False), None
    tmod.train(train)
    got = tmod(to_nchw(x))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **TOL)
    if train:
        # Flax momentum .99 = torch 0.01, and the BIASED batch variance
        bs = mutated["batch_stats"]["bn"]
        np.testing.assert_allclose(tmod.bn.running_mean.numpy(), np.asarray(bs["mean"]), **TOL)
        np.testing.assert_allclose(tmod.bn.running_var.numpy(), np.asarray(bs["var"]), **TOL)
    else:
        np.testing.assert_array_equal(tmod.bn.running_var.numpy(),
                                      variables["batch_stats"]["bn"]["var"])


def test_running_var_is_the_biased_batch_variance():
    """Hand check of the trap, independent of flax: new = .99 old + .01 var_biased."""
    tmod = tl.BatchNorm(3)
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 4, 4).astype(np.float32))
    tmod.train()
    tmod(x)
    var_b = x.permute(1, 0, 2, 3).reshape(3, -1).var(dim=1, unbiased=False)
    np.testing.assert_allclose(tmod.running_var.numpy(), (0.99 + 0.01 * var_b).numpy(), rtol=1e-6)


@pytest.mark.parametrize("kernel,activation", [(3, "relu"), (1, "softplus"), (3, None)])
def test_conv_block_no_norm(kernel, activation):
    x, jmod, variables, tmod = _pair("none", activation, kernel=kernel, seed=2)
    variables["params"]["conv"]["bias"] = np.random.RandomState(3).randn(8).astype(np.float32)
    tmod.load_state_dict(flax_to_state_dict(variables, tmod))
    want = jmod.apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(to_nhwc(tmod(to_nchw(x))), np.asarray(want), **TOL)


def test_conv_block_bf16_dtype_policy():
    """Conv in bf16, BN in f32, output cast back to bf16; parameters stay f32."""
    blk = tl.ConvBlock(3, 4, norm="batch", dtype=torch.bfloat16)
    y = blk(torch.randn(2, 3, 8, 8))
    assert y.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in blk.parameters())
    assert blk.bn.running_mean.dtype == torch.float32


def test_conv_block_rejects_unported_norms():
    """No norm of the JAX ConvBlock is left unported: batch_bf16 builds with
    batch's `bn` parameters and buffers and, as in JAX (use_bias = norm !=
    "batch"), a conv bias, and its parity with flax is held in
    tests/test_torch_blocks.py; a name the JAX ConvBlock does not know
    raises ValueError with JAX's words. The other norms are held against
    JAX in tests/test_torch_norms.py."""
    x, jmod, variables, tmod = _pair("batch", "relu")
    blk = tl.ConvBlock(3, 8, norm="batch_bf16")
    assert sorted(blk.state_dict()) == sorted([*tmod.state_dict(), "conv.bias"])
    blk.load_state_dict({**flax_to_state_dict(variables, tmod), "conv.bias": torch.zeros(8)})
    blk.eval()
    np.testing.assert_allclose(to_nhwc(blk(to_nchw(x))),
                               np.asarray(jmod.apply(variables, jnp.asarray(x))), **TOL)
    with pytest.raises(ValueError, match="unknown norm: 'batch_f16'"):
        tl.ConvBlock(3, 4, norm="batch_f16")


@pytest.mark.parametrize("hw", [(8, 8), (7, 5)])
def test_avg_pool_2x2_same_padding(hw):
    x = np.random.RandomState(4).randn(2, hw[0], hw[1], 3).astype(np.float32)
    want = jl.avg_pool_2x2(jnp.asarray(x))
    np.testing.assert_allclose(to_nhwc(tl.avg_pool_2x2(to_nchw(x))), np.asarray(want), **TOL)


def test_upsample_bilinear_is_half_pixel_align_corners_false():
    x = np.random.RandomState(5).randn(2, 5, 6, 3).astype(np.float32)
    want = np.asarray(jl.upsample_bilinear(jnp.asarray(x), 2))
    got = tl.upsample_bilinear(to_nchw(x), 2)
    ref = F.interpolate(to_nchw(x), scale_factor=2, mode="bilinear", align_corners=False)
    np.testing.assert_allclose(to_nhwc(got), want, **TOL)
    np.testing.assert_allclose(to_nhwc(ref), want, **TOL)


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_resize_nearest_integer_factor_repeats_pixels(factor):
    x = np.random.RandomState(6).randn(2, 4, 4, 2).astype(np.float32)
    size = (4 * factor, 4 * factor)
    want = np.asarray(jl.resize_nearest(jnp.asarray(x), size))
    got = to_nhwc(tl.resize_nearest(to_nchw(x), size))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x.repeat(factor, 1).repeat(factor, 2))


def test_reparameterize_with_injected_and_drawn_noise():
    mu, sigma = torch.zeros(2, 3), torch.full((2, 3), 2.0)
    eps = torch.ones(2, 3)
    assert torch.equal(tl.reparameterize(mu, sigma, eps), torch.full((2, 3), 2.0))
    g1, g2 = torch.Generator().manual_seed(0), torch.Generator().manual_seed(0)
    assert torch.equal(tl.reparameterize(mu, sigma, generator=g1),
                       tl.reparameterize(mu, sigma, generator=g2))


def test_he_normal_init_is_truncated_at_two_std():
    blk = tl.ConvBlock(16, 64, norm="none")
    blk.conv.bias.data.fill_(1.0)
    tl.init_weights_(blk, torch.Generator().manual_seed(0))
    w = blk.conv.weight
    std = np.sqrt(2.0 / (16 * 9)) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-7
    assert abs(float(w.std()) - np.sqrt(2.0 / (16 * 9))) < 0.05 * np.sqrt(2.0 / (16 * 9))
    assert float(blk.conv.bias.abs().max()) == 0.0


@pytest.mark.parametrize("hw", [(8, 8), (7, 5)])
def test_max_pool_2x2_same_padding(hw):
    x = np.random.RandomState(7).randn(2, hw[0], hw[1], 3).astype(np.float32)
    want = jl.max_pool_2x2(jnp.asarray(x))
    np.testing.assert_allclose(to_nhwc(tl.max_pool_2x2(to_nchw(x))), np.asarray(want), **TOL)


@pytest.mark.parametrize("size", [(10, 12), (16, 9), (3, 4), (5, 13), (8, 6)])
def test_resize_bilinear_antialiases_like_jax(size):
    """From 8x6: upsamples, downsamples (jax.image antialiases there), both
    at once, and the identity."""
    x = np.random.RandomState(8).randn(2, 8, 6, 3).astype(np.float32)
    want = np.asarray(jl.resize_bilinear(jnp.asarray(x), size))
    got = to_nhwc(tl.resize_bilinear(to_nchw(x), size))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("factor", [1, 2, 3])
def test_upsample_nearest(factor):
    x = np.random.RandomState(9).randn(2, 5, 3, 2).astype(np.float32)
    want = np.asarray(jl.upsample_nearest(jnp.asarray(x), factor))
    np.testing.assert_array_equal(to_nhwc(tl.upsample_nearest(to_nchw(x), factor)), want)


def _flax_pair(jmod, tmod, x, seed):
    variables = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(seed), x))
    tmod.load_state_dict(flax_to_state_dict(variables, tmod))
    return variables


@pytest.mark.parametrize("down_sample,cin,norm", [(False, 8, "batch"), (False, 3, "none"),
                                                  (True, 8, "batch"), (True, 4, "none")])
@pytest.mark.parametrize("train", [True, False])
def test_residual_unit(down_sample, cin, norm, train):
    """The shortcut is x or the 1x1 `proj`; c1 strides 2 with Flax's SAME
    padding when the unit downsamples; scopes proj / c1 / c2."""
    x = np.random.RandomState(10).randn(4, 8, 8, cin).astype(np.float32)
    jmod = jl.ResidualUnit(8, down_sample=down_sample, norm=norm)
    tmod = tl.ResidualUnit(cin, 8, down_sample=down_sample, norm=norm)
    variables = _flax_pair(jmod, tmod, jnp.asarray(x), 1)
    assert ("proj" in variables["params"]) == (tmod.proj is not None)
    if train and norm == "batch":
        want, _ = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jmod.apply(variables, jnp.asarray(x), train=train)
    tmod.train(train)
    got = tmod(to_nchw(x))
    assert got.shape == (4, 8, 4 if down_sample else 8, 4 if down_sample else 8)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("activation", ["relu", None])
@pytest.mark.parametrize("shape", [(5, 6), (2, 3, 6)])
def test_dense(activation, shape):
    x = np.random.RandomState(11).randn(*shape).astype(np.float32)
    jmod = jl.Dense(4, activation=jax.nn.relu if activation else None)
    tmod = tl.Dense(6, 4, activation=F.relu if activation else None)
    variables = _flax_pair(jmod, tmod, jnp.asarray(x), 2)
    want = jmod.apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(tmod(torch.from_numpy(x)).detach().numpy(), np.asarray(want), **TOL)


def test_residual_unit_and_dense_init_like_flax():
    """he_normal (Flax's: a normal of variance 2 / fan_in before the
    truncation at two standard deviations) and zero biases for the
    projection and the dense kernel."""
    unit, dense = tl.ResidualUnit(4, 16, down_sample=True), tl.Dense(300, 50)
    g = torch.Generator().manual_seed(0)
    for m in (unit, dense):
        tl.init_weights_(m, g)
    for w, fan_in in ((unit.proj.weight, 4), (dense.Dense_0.weight, 300)):
        std = np.sqrt(2.0 / fan_in)  # of the truncated draw
        assert float(w.detach().abs().max()) <= 2 * std / tl._TRUNC_STD + 1e-6
        assert abs(float(w.detach().std()) / std - 1) < 0.25
    assert not unit.proj.bias.detach().any() and not dense.Dense_0.bias.detach().any()


def test_nn_package_exports_what_jax_exports():
    import phiseg_tpu.nn as jnn
    import phiseg_tpu_torch.nn as tnn

    assert tnn.__all__ == jnn.__all__
    assert all(hasattr(tnn, n) for n in tnn.__all__)
