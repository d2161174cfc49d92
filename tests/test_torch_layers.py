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
    """batch_bf16, the TPU variant the port does not carry, raises; the other
    norms are held against JAX in tests/test_torch_norms.py."""
    with pytest.raises(NotImplementedError, match="batch_bf16"):
        tl.ConvBlock(3, 4, norm="batch_bf16")


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
