"""The port's transposed, dilated and 3-D conv blocks, its 3-D resizes and
pools, its padding / space-to-depth / crop helpers and ConvBlock's
`batch_bf16` norm, against phiseg_tpu.nn.layers on the CPU.

Inputs and weights come from numpy with a seed; every weight of the Flax
tree is drawn at random (batch norm's variance from U(0.5, 2)) and carried
into the port by convert.flax_to_state_dict. The JAX side runs NHWC / NDHWC,
the port NCHW / NCDHW. Tolerances:
  * TOL, rtol / atol 1e-5: f32 round-off of convolutions and batch
    statistics summed in another order (tests/test_torch_layers.py);
  * GRAD_TOL, 1e-4 of the largest entry of each gradient: sums of ~1e3
    products of O(1) values, in another order;
  * BF16_TOL for a bf16 block: the two frameworks round the bf16
    convolution's f32 sums to bf16 after summing in another order, so a
    value of the conv output may sit one bf16 ulp apart (2^-8 of it); the
    normalisation scales that by scale / std (< 2 here) and the output is
    rounded to bf16 again (one more ulp). atol 2^-5 covers two ulps of
    values below 4; rtol 2^-6 two ulps of larger ones;
  * the running statistics of a bf16 block: means of bf16 values that may
    differ by an ulp, rtol / atol 2^-8.
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
GRAD_TOL = 1e-4
BF16_TOL = dict(rtol=2 ** -6, atol=2 ** -5)
BF16_STATS_TOL = dict(rtol=2 ** -8, atol=2 ** -8)


def to_torch(a):
    """NHWC / NDHWC numpy -> NCHW / NCDHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def to_numpy(t):
    """NCHW / NCDHW tensor -> NHWC / NDHWC f32 numpy."""
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def random_variables(variables, rng):
    """Every leaf of a Flax tree drawn from rng: kernels at he_normal's
    scale, biases N(0, 0.5^2), norm scales 1 + N(0, 0.5^2), running means
    N(0, 0.5^2), running variances U(0.5, 2)."""

    def draw(path, a):
        a = np.asarray(a)
        key = path[-1].key
        if key == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        scale = np.sqrt(2.0 / np.prod(a.shape[:-1])) if a.ndim > 1 else 0.5
        return (rng.randn(*a.shape) * scale + (key == "scale")).astype(np.float32)

    return {col: jax.tree_util.tree_map_with_path(draw, tree) for col, tree in variables.items()}


# (id, flax block, port block from norm, NHWC / NDHWC input shape)
BLOCKS = [
    ("transposed_k4s2_even", lambda n: jl.TransposedConvBlock(8, norm=n),
     lambda n: tl.TransposedConvBlock(3, 8, norm=n), (2, 6, 4, 3)),
    ("transposed_k4s2_odd", lambda n: jl.TransposedConvBlock(8, norm=n),
     lambda n: tl.TransposedConvBlock(3, 8, norm=n), (2, 5, 7, 3)),
    ("transposed_k3s2_even", lambda n: jl.TransposedConvBlock(8, (3, 3), norm=n),
     lambda n: tl.TransposedConvBlock(3, 8, 3, norm=n), (2, 6, 4, 3)),
    ("transposed_k3s2_odd", lambda n: jl.TransposedConvBlock(8, (3, 3), norm=n),
     lambda n: tl.TransposedConvBlock(3, 8, 3, norm=n), (2, 5, 7, 3)),
    ("dilated_rate2", lambda n: jl.DilatedConvBlock(8, rate=2, norm=n),
     lambda n: tl.DilatedConvBlock(3, 8, rate=2, norm=n), (2, 7, 6, 3)),
    ("dilated_rate3", lambda n: jl.DilatedConvBlock(8, rate=3, norm=n),
     lambda n: tl.DilatedConvBlock(3, 8, rate=3, norm=n), (2, 7, 6, 3)),
    ("conv3d_stride1", lambda n: jl.Conv3DBlock(8, norm=n),
     lambda n: tl.Conv3DBlock(3, 8, norm=n), (2, 5, 4, 6, 3)),
    ("conv3d_stride2", lambda n: jl.Conv3DBlock(8, strides=(2, 2, 2), norm=n),
     lambda n: tl.Conv3DBlock(3, 8, stride=2, norm=n), (2, 5, 4, 6, 3)),
    ("transposed3d_k4s2", lambda n: jl.TransposedConv3DBlock(8, norm=n),
     lambda n: tl.TransposedConv3DBlock(3, 8, norm=n), (2, 3, 4, 5, 3)),
    ("transposed3d_k3s2", lambda n: jl.TransposedConv3DBlock(8, (3, 3, 3), norm=n),
     lambda n: tl.TransposedConv3DBlock(3, 8, 3, norm=n), (2, 3, 4, 5, 3)),
]
BLOCK_IDS = [b[0] for b in BLOCKS]


def _block_pair(case, norm, seed=0):
    _, jmake, tmake, shape = case
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    jmod = jmake(norm)
    variables = random_variables(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x)), rng)
    tmod = tmake(norm)
    tmod.load_state_dict(flax_to_state_dict(variables, tmod))
    return x, jmod, variables, tmod


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("norm", tl.TAIL_NORMS)
@pytest.mark.parametrize("case", BLOCKS, ids=BLOCK_IDS)
def test_block_matches_jax(case, norm, train):
    """Output shape and values; with batch norm in training, the running
    statistics after the step too."""
    x, jmod, variables, tmod = _block_pair(case, norm)
    mutated = None
    if train and norm == "batch":
        want, mutated = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jmod.apply(variables, jnp.asarray(x), train=train)
    tmod.train(train)
    got = to_numpy(tmod(to_torch(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if mutated is not None:
        bs = mutated["batch_stats"]["bn"]
        np.testing.assert_allclose(tmod.bn.running_mean.numpy(), np.asarray(bs["mean"]), **TOL)
        np.testing.assert_allclose(tmod.bn.running_var.numpy(), np.asarray(bs["var"]), **TOL)


def _assert_grads_close(got, want, what):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= GRAD_TOL * scale, what


@pytest.mark.parametrize("case", [BLOCKS[i] for i in (3, 5, 7, 9)],
                         ids=[BLOCK_IDS[i] for i in (3, 5, 7, 9)])
def test_block_gradients_match_jax_grad(case):
    """The gradients of <block(x), r> for a random cotangent r with respect
    to x and to every parameter, batch norm in training, against jax.grad."""
    x, jmod, variables, tmod = _block_pair(case, "batch", seed=1)
    out_shape = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])[0].shape
    r = np.random.RandomState(2).randn(*out_shape).astype(np.float32)

    def loss(params, xx):
        out = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]}, xx,
                         train=True, mutable=["batch_stats"])[0]
        return jnp.sum(out * r)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(variables["params"], jnp.asarray(x))
    want = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, g_params),
                               "batch_stats": variables["batch_stats"]}, tmod)
    tmod.train()
    xt = to_torch(x).requires_grad_(True)
    (tmod(xt) * to_torch(r)).sum().backward()
    _assert_grads_close(to_numpy(xt.grad), np.asarray(g_x), "input")
    for name, p in tmod.named_parameters():
        _assert_grads_close(p.grad.numpy(), want[name].numpy(), name)


@pytest.mark.parametrize("norm", ["layer", "instance", "renorm", "batch_bf16", "bogus"])
@pytest.mark.parametrize("kind", ["transposed", "dilated", "conv3d", "transposed3d"])
def test_block_rejects_the_norms_jax_rejects(kind, norm):
    """`_norm_act` knows batch, group and none only; JAX raises ValueError
    at init, the port when the block is built, with the same words."""
    jmake, tmake, shape = {
        "transposed": (jl.TransposedConvBlock, tl.TransposedConvBlock, (1, 4, 4, 3)),
        "dilated": (jl.DilatedConvBlock, tl.DilatedConvBlock, (1, 4, 4, 3)),
        "conv3d": (jl.Conv3DBlock, tl.Conv3DBlock, (1, 4, 4, 4, 3)),
        "transposed3d": (jl.TransposedConv3DBlock, tl.TransposedConv3DBlock, (1, 2, 2, 2, 3)),
    }[kind]
    msg = f"unknown norm: {norm!r}"
    with pytest.raises(ValueError) as jax_err:
        jmake(8, norm=norm).init(jax.random.PRNGKey(0), jnp.zeros(shape))
    assert str(jax_err.value) == msg
    with pytest.raises(ValueError) as port_err:
        tmake(3, 8, norm=norm)
    assert str(port_err.value) == msg


@pytest.mark.parametrize("kind", ["transposed", "dilated", "conv3d", "transposed3d"])
def test_block_init_is_he_normal_over_flax_fan_in(kind):
    """init_weights_ draws the kernel at he_normal's scale with Flax's fan-in
    (a transposed kernel's `in` is torch's dim 0) and zeroes the bias."""
    blk = {"transposed": lambda: tl.TransposedConvBlock(24, 4),
           "dilated": lambda: tl.DilatedConvBlock(24, 40),
           "conv3d": lambda: tl.Conv3DBlock(24, 40),
           "transposed3d": lambda: tl.TransposedConv3DBlock(24, 4)}[kind]()
    conv = blk.conv_module
    with torch.no_grad():
        conv.bias.fill_(1.0)
    tl.init_weights_(blk, torch.Generator().manual_seed(0))
    fan_in = 24 * int(np.prod(conv.kernel_size))
    std = np.sqrt(2.0 / fan_in)
    w = conv.weight.detach()
    assert float(w.abs().max()) <= 2 * std / tl._TRUNC_STD + 1e-6
    assert abs(float(w.std()) / std - 1) < 0.1
    assert not conv.bias.detach().any()


# -- functions ---------------------------------------------------------------------


@pytest.mark.parametrize("dhw", [(4, 6, 8), (3, 5, 4), (3, 3, 3)])
@pytest.mark.parametrize("pool", ["avg_pool_2x2x2", "max_pool_2x2x2"])
def test_pool_2x2x2_same_padding(pool, dhw):
    """Odd sides: flax pads the high edge (zeros counted in the mean, -inf
    for the max)."""
    x = np.random.RandomState(3).randn(2, *dhw, 3).astype(np.float32)
    want = np.asarray(getattr(jl, pool)(jnp.asarray(x)))
    got = to_numpy(getattr(tl, pool)(to_torch(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_avg_pool_2x2x2_counts_the_padding_in_the_mean():
    """On a 3x3x3 cube of ones the corner window holds one pixel and seven
    zeros of padding: 0.125, as flax gives it."""
    got = tl.avg_pool_2x2x2(torch.ones(1, 1, 3, 3, 3))
    assert float(got[0, 0, 1, 1, 1]) == 0.125 and float(got[0, 0, 0, 0, 0]) == 1.0


# from (8, 6, 5): shrink on every axis (8^3 -> 4^3 below is the case torch's
# trilinear gets wrong), grow, mixed, and the identity
RESIZE_SIZES = [(4, 3, 2), (12, 9, 7), (4, 9, 5), (8, 6, 5), (3, 11, 2)]


@pytest.mark.parametrize("size", RESIZE_SIZES)
def test_resize_bilinear_3d_antialiases_like_jax(size):
    x = np.random.RandomState(4).randn(2, 8, 6, 5, 3).astype(np.float32)
    want = np.asarray(jl.resize_bilinear_3d(jnp.asarray(x), size))
    got = to_numpy(tl.resize_bilinear_3d(to_torch(x), size))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_trilinear_shrink_needs_the_antialiasing():
    """8^3 -> 4^3: the port matches jax.image; torch's own trilinear, which
    does not antialias, does not."""
    x = np.random.RandomState(5).randn(1, 8, 8, 8, 2).astype(np.float32)
    want = np.asarray(jl.resize_bilinear_3d(jnp.asarray(x), (4, 4, 4)))
    np.testing.assert_allclose(to_numpy(tl.resize_bilinear_3d(to_torch(x), (4, 4, 4))), want,
                               **TOL)
    plain = to_numpy(F.interpolate(to_torch(x), size=(4, 4, 4), mode="trilinear",
                                   align_corners=False))
    assert float(np.abs(plain - want).max()) > 0.1


@pytest.mark.parametrize("size", RESIZE_SIZES)
def test_resize_nearest_3d_like_jax(size):
    x = np.random.RandomState(6).randn(2, 8, 6, 5, 3).astype(np.float32)
    want = np.asarray(jl.resize_nearest_3d(jnp.asarray(x), size))
    np.testing.assert_array_equal(to_numpy(tl.resize_nearest_3d(to_torch(x), size)), want)


@pytest.mark.parametrize("factor", [1, 2, 3])
@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_upsample_3d(method, factor):
    x = np.random.RandomState(7).randn(2, 3, 4, 2, 2).astype(np.float32)
    want = np.asarray(getattr(jl, f"upsample_{method}_3d")(jnp.asarray(x), factor))
    got = to_numpy(getattr(tl, f"upsample_{method}_3d")(to_torch(x), factor))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("target", [(8, 9), (5, 6), (6, 11)])
def test_pad_to_size(target):
    x = np.random.RandomState(8).randn(2, 5, 6, 3).astype(np.float32)
    want = np.asarray(jl.pad_to_size(jnp.asarray(x), target))
    np.testing.assert_array_equal(to_numpy(tl.pad_to_size(to_torch(x), target)), want)


def test_pad_to_size_raises_like_jax_on_a_smaller_target():
    x = np.zeros((1, 5, 6, 2), np.float32)
    with pytest.raises(ValueError) as jax_err:
        jl.pad_to_size(jnp.asarray(x), (4, 8))
    with pytest.raises(ValueError) as port_err:
        tl.pad_to_size(to_torch(x), (4, 8))
    assert str(port_err.value) == str(jax_err.value)


def test_reshape_pool_2x2_channel_order():
    """Channel k of quarter q is channel q * C + k, as JAX's concat orders
    them: (even, even), (odd, even), (even, odd), (odd, odd) pixels."""
    x = np.random.RandomState(9).randn(2, 6, 8, 3).astype(np.float32)
    want = np.asarray(jl.reshape_pool_2x2(jnp.asarray(x)))
    got = to_numpy(tl.reshape_pool_2x2(to_torch(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., 3:6], x[:, 1::2, 0::2, :])


@pytest.mark.parametrize("axis", [-1, 3, 0, 1, 2, -3])
def test_crop_and_concat_on_unequal_sizes(axis):
    """Centre crop to the smallest (H, W), concatenated on JAX's NHWC axis."""
    rng = np.random.RandomState(10)
    ts = [rng.randn(2, h, w, 3).astype(np.float32) for h, w in ((7, 9), (5, 6), (6, 8))]
    want = np.asarray(jl.crop_and_concat([jnp.asarray(t) for t in ts], axis=axis))
    got = to_numpy(tl.crop_and_concat([to_torch(t) for t in ts], axis=axis))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- batch_bf16 --------------------------------------------------------------------


def _bf16_pair(norm, activation, dtype, seed=11):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 8, 8, 3).astype(np.float32)
    jact = {"relu": jax.nn.relu, "elu": jax.nn.elu, None: None}[activation]
    jmod = jl.ConvBlock(8, norm=norm, activation=jact,
                        dtype={torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}[dtype])
    variables = random_variables(jmod.init(jax.random.PRNGKey(seed), jnp.asarray(x)), rng)
    tmod = tl.ConvBlock(3, 8, norm=norm, dtype=dtype,
                        activation={"relu": F.relu, "elu": F.elu, None: None}[activation])
    tmod.load_state_dict(flax_to_state_dict(variables, tmod))
    return x, jmod, variables, tmod


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("activation", ["relu", "elu", None])
def test_batch_bf16_matches_flax_in_bf16(activation, train):
    """ConvBlock(norm="batch_bf16") with a bf16 compute dtype against flax's:
    the output in bf16 within BF16_TOL, the running statistics (f32) after a
    training step within BF16_STATS_TOL."""
    x, jmod, variables, tmod = _bf16_pair("batch_bf16", activation, torch.bfloat16)
    if train:
        want, mutated = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jmod.apply(variables, jnp.asarray(x), train=False)
    tmod.train(train)
    got = tmod(to_torch(x))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(to_numpy(got), np.asarray(want, np.float32), **BF16_TOL)
    if train:
        bs = mutated["batch_stats"]["bn"]
        np.testing.assert_allclose(tmod.bn.running_mean.numpy(), np.asarray(bs["mean"]),
                                   **BF16_STATS_TOL)
        np.testing.assert_allclose(tmod.bn.running_var.numpy(), np.asarray(bs["var"]),
                                   **BF16_STATS_TOL)


@pytest.mark.parametrize("train", [True, False])
def test_batch_bf16_in_f32_is_flax_batch_bf16(train):
    """With an f32 compute dtype the cast is a no-op: within TOL of flax."""
    x, jmod, variables, tmod = _bf16_pair("batch_bf16", "elu", torch.float32)
    if train:
        want, _ = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jmod.apply(variables, jnp.asarray(x), train=False)
    tmod.train(train)
    np.testing.assert_allclose(to_numpy(tmod(to_torch(x))), np.asarray(want), **TOL)


def _batch_twin(bf16_block):
    """A norm="batch" block with bf16_block's weights and statistics: the
    same `bn` entries; "batch" has no conv bias, so bf16_block's is zeroed."""
    twin = tl.ConvBlock(3, 8, norm="batch", dtype=bf16_block.dtype,
                        activation=bf16_block.activation)
    with torch.no_grad():
        bf16_block.conv.bias.zero_()
    missing, unexpected = twin.load_state_dict(bf16_block.state_dict(), strict=False)
    assert missing == [] and unexpected == ["conv.bias"]
    return twin


@pytest.mark.parametrize("train", [True, False])
def test_batch_bf16_with_relu_is_batch_bitwise(train):
    """ReLU commutes with the rounding to bf16, so batch_bf16 (round, then
    ReLU in bf16) equals batch (ReLU in f32, then round) bit for bit, the
    running statistics too."""
    x, _, _, bf16 = _bf16_pair("batch_bf16", "relu", torch.bfloat16)
    twin = _batch_twin(bf16)
    bf16.train(train)
    twin.train(train)
    a, b = bf16(to_torch(x)), twin(to_torch(x))
    assert a.dtype == b.dtype == torch.bfloat16
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(bf16.bn.running_mean, twin.bn.running_mean)
    assert torch.equal(bf16.bn.running_var, twin.bn.running_var)


def test_batch_bf16_with_elu_differs_from_batch_by_bf16_rounding():
    """ELU does not commute with the rounding: within one bf16 ulp of the
    value (2^-8 relative) plus 2^-9 absolute, and not bitwise."""
    x, _, _, bf16 = _bf16_pair("batch_bf16", "elu", torch.bfloat16)
    twin = _batch_twin(bf16)
    a, b = bf16(to_torch(x)).detach().float(), twin(to_torch(x)).detach().float()
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2 ** -8, atol=2 ** -9)
    assert not torch.equal(a, b)


def test_flax_batch_tree_loads_into_a_batch_bf16_block():
    """The `bn` leaves of a Flax "batch" tree fill a port batch_bf16 block;
    its conv bias, which "batch" lacks (JAX: use_bias = norm != "batch"),
    stays at Flax's zero init. In f32 the block then gives flax's "batch"
    output, and the reverse load works too."""
    x, jmod, variables, tbatch = _bf16_pair("batch", "relu", torch.float32)
    bf16 = tl.ConvBlock(3, 8, norm="batch_bf16")
    tl.init_weights_(bf16, torch.Generator().manual_seed(0))
    missing, unexpected = bf16.load_state_dict(flax_to_state_dict(variables, tbatch),
                                               strict=False)
    assert missing == ["conv.bias"] and unexpected == []
    for train in (False, True):
        bf16.train(train)
        want = jmod.apply(variables, jnp.asarray(x), train=train, mutable=["batch_stats"])[0]
        np.testing.assert_allclose(to_numpy(bf16(to_torch(x))), np.asarray(want), **TOL)
    back = _batch_twin(bf16)
    assert all(torch.equal(back.state_dict()[k], v) for k, v in bf16.state_dict().items()
               if k != "conv.bias")


# -- convert.py ----------------------------------------------------------------------


@pytest.mark.parametrize("case", [BLOCKS[2], BLOCKS[9]], ids=[BLOCK_IDS[2], BLOCK_IDS[9]])
def test_adam_moments_of_a_transposed_kernel_carry_flipped(case):
    """flax_train_state_to_port places optax's mu / nu of a transposed
    kernel as it places the kernel: flipped in space, (in, out) first."""
    import types

    from phiseg_tpu_torch.convert import flax_train_state_to_port

    x, _, variables, tmod = _block_pair(case, "group")
    rng = np.random.RandomState(12)
    mu = random_variables({"params": variables["params"]}, rng)["params"]
    nu = jax.tree_util.tree_map(np.abs, random_variables({"params": variables["params"]},
                                                         rng)["params"])
    tree = {"step": np.int32(3), "params": variables["params"], "batch_stats": {},
            "opt_state": {"0": {"count": np.int32(3), "mu": mu, "nu": nu},
                          "1": {"count": np.int32(3)}}}
    state = types.SimpleNamespace(model=tmod, step=0,
                                  optimizer=torch.optim.Adam(tmod.parameters(), lr=1e-3))
    flax_train_state_to_port(tree, state)
    want_mu = flax_to_state_dict({"params": mu}, tmod)
    want_nu = flax_to_state_dict({"params": nu}, tmod)
    k = tree["params"][tmod.scope]["kernel"]
    assert torch.equal(want_mu[f"{tmod.scope}.weight"],
                       torch.from_numpy(np.ascontiguousarray(
                           np.moveaxis(mu[tmod.scope]["kernel"], (-2, -1), (0, 1))[
                               (slice(None),) * 2 + (slice(None, None, -1),) * (k.ndim - 2)])))
    for name, p in tmod.named_parameters():
        st = state.optimizer.state[p]
        assert float(st["step"]) == 3 and state.step == 3
        assert torch.equal(st["exp_avg"], want_mu[name]) and torch.equal(st["exp_avg_sq"],
                                                                         want_nu[name])


def test_a_leaf_of_another_block_kind_still_raises():
    """A transposed kernel offered to a dilated block has no place there."""
    _, _, variables, _ = _block_pair(BLOCKS[0], "none")
    with pytest.raises(KeyError, match="conv_t"):
        flax_to_state_dict(variables, tl.DilatedConvBlock(3, 8))
