"""The port's other norms, BatchRenorm, the init registry, dropout, the
activations and the library losses vs the JAX package on the CPU.

Inputs come from numpy with a seed; the JAX side runs NHWC, the port NCHW,
and the weights go to the port through phiseg_tpu_torch.convert. Tolerances:
rtol/atol 1e-5 for one block or one loss (f32 sums in another order on O(1)
values; Flax's group and layer norms take the variance as E[x^2] - E[x]^2,
torch as the mean squared deviation); rtol/atol 1e-3 for a whole SegVAE, as
tests/test_torch_models.py (twenty-odd blocks in a chain, and at the
coarsest level a norm over a few values magnifies the round-off).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from phiseg_tpu.engine.config import ExperimentConfig as JaxConfig
from phiseg_tpu.engine.objective import phiseg_objective as jax_objective
from phiseg_tpu.models import SegVAE as JaxSegVAE
from phiseg_tpu.nn import activations as jact
from phiseg_tpu.nn import layers as jl
from phiseg_tpu.nn import losses as jlosses
from phiseg_tpu.nn.normalization import BatchRenorm as JaxBatchRenorm
from phiseg_tpu_torch.convert import flax_to_state_dict
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.objective import phiseg_objective
from phiseg_tpu_torch.models import SegVAE
from phiseg_tpu_torch.nn import activations as tact
from phiseg_tpu_torch.nn import layers as tl
from phiseg_tpu_torch.nn import losses as tlosses
from phiseg_tpu_torch.nn.normalization import BatchRenorm
from phiseg_tpu_torch.parallel import make_mesh, shard_array, spawn_ranks

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-3, atol=1e-3)
NEW_NORMS = ["group", "layer", "renorm", "instance"]


def to_nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _fill(rng, steps=1000):
    """Numpy values for a Flax tree's leaves: he-scaled kernels, non-trivial
    biases, scales, running statistics and instance-norm parameters."""

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("bias", "in_scale", "in_offset", "mean"):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "steps":
            return np.full(leaf.shape, steps, np.int32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)  # scale, var

    return fill


def _block_pair(norm, cin=3, cout=32, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 8, 8, cin).astype(np.float32)
    jmod = jl.ConvBlock(cout, norm=norm)
    shapes = jax.eval_shape(lambda k, a: jmod.init({"params": k}, a, train=False),
                            jax.random.PRNGKey(seed), jnp.asarray(x))
    variables = jax.tree_util.tree_map_with_path(_fill(rng), shapes)
    tmod = tl.ConvBlock(cin, cout, norm=norm)
    tmod.load_state_dict(flax_to_state_dict(variables, tmod))
    return x, rng.randn(4, 8, 8, cout).astype(np.float32), jmod, variables, tmod


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("norm", NEW_NORMS + ["batch", "none"])
def test_conv_block_norm_matches_jax(norm, train):
    """Forward in training and eval mode, the batch statistics a training
    call leaves, and the input gradient of sum(out * w)."""
    x, w, jmod, variables, tmod = _block_pair(norm)
    mutable = ["batch_stats"] if train and "batch_stats" in variables else False

    def f(xx):
        out = jmod.apply(variables, xx, train=train, mutable=mutable)
        y, upd = out if mutable else (out, None)
        return jnp.sum(y * w), (y, upd)

    (_, (want, upd)), gx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    tmod.train(train)
    xt = to_nchw(x).requires_grad_(True)
    got = tmod(xt)
    (got * to_nchw(w)).sum().backward()
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(to_nhwc(xt.grad), np.asarray(gx), **TOL)
    if upd is not None:
        want_sd = flax_to_state_dict({"params": variables["params"], **upd}, tmod)
        for name, t in tmod.state_dict().items():
            np.testing.assert_allclose(t.numpy(), want_sd[name].numpy(), err_msg=name, **TOL)


def test_conv_block_scopes_and_bias_rule():
    """The Flax scopes of each norm, and a conv bias unless norm="batch"
    (renorm keeps it, as JAX's use_bias = norm != "batch")."""
    names = {norm: sorted(tl.ConvBlock(3, 32, norm=norm).state_dict()) for norm in NEW_NORMS}
    assert names["group"] == ["conv.bias", "conv.weight", "gn.bias", "gn.weight"]
    assert names["layer"] == ["conv.bias", "conv.weight", "ln.bias", "ln.weight"]
    assert names["renorm"] == ["brn.bias", "brn.running_mean", "brn.running_var", "brn.steps",
                               "brn.weight", "conv.bias", "conv.weight"]
    assert names["instance"] == ["conv.bias", "conv.weight", "in_offset", "in_scale"]
    assert tl.ConvBlock(3, 32, norm="batch").conv.bias is None
    assert tl.ConvBlock(3, 32, norm="group").gn.num_groups == 2
    assert tl.ConvBlock(3, 64, norm="group").gn.num_groups == 4
    with pytest.raises(ValueError, match="unknown norm"):
        tl.ConvBlock(3, 4, norm="bogus")
    with pytest.raises(ValueError, match="unknown weight_init"):
        tl.ConvBlock(3, 4, weight_init="bogus")


@pytest.mark.parametrize("norm", NEW_NORMS + ["batch"])
def test_conv_block_bf16_dtype_policy_per_norm(norm):
    """Under bf16 compute the block's output is bf16 and its parameters and
    statistics stay f32. The norm's own output: batch, group and layer in
    f32; renorm computes in f32 and returns the conv's dtype; instance runs
    in the conv's dtype (JAX layers.py:163-200)."""
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 8, 8).astype(np.float32))
    blk = tl.ConvBlock(3, 32, norm=norm, dtype=torch.bfloat16)
    tl.init_weights_(blk, torch.Generator().manual_seed(0))
    assert blk(x).dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in blk.parameters())
    bias = None if blk.conv.bias is None else blk.conv.bias.bfloat16()
    conv = F.conv2d(x.bfloat16(), blk.conv.weight.bfloat16(), bias, padding=1)
    want = torch.bfloat16 if norm in ("renorm", "instance") else torch.float32
    assert blk._normalise(conv).dtype == want


def _segvae_pair(norm, R=4, L=2, hw=16, n0=4, b=2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, hw, hw, 1).astype(np.float32)
    s_oh = np.eye(2, dtype=np.float32)[(rng.rand(b, hw, hw) > 0.6).astype(np.int64)]
    kw = dict(model_family="phiseg", latent_levels=L, resolution_levels=R, n0=n0, zdim0=2,
              nlabels=2, image_size=(hw, hw), norm=norm)
    jmod = JaxSegVAE(**kw)
    key = jax.random.PRNGKey(seed)
    shapes = jax.eval_shape(lambda k, a, s: jmod.init({"params": k}, a, s, k, train=True),
                            key, jnp.asarray(x), jnp.asarray(s_oh))
    variables = jax.tree_util.tree_map_with_path(_fill(rng, steps=3000), shapes)
    tmod = SegVAE(**kw, dtype=torch.float32, image_channels=1)
    sd = flax_to_state_dict(variables, tmod)  # raises on a leaf left over, or an entry
    tmod.load_state_dict(sd)
    return x, s_oh, jmod, variables, tmod, key


@pytest.mark.parametrize("norm", NEW_NORMS)
def test_segvae_per_norm_forward_and_losses_match_jax(norm):
    """A tiny SegVAE per norm in training mode: every output level and the
    loss dict against JAX, and (renorm) the running statistics and steps."""
    x, s_oh, jmod, variables, tmod, key = _segvae_pair(norm)
    mutable = ["batch_stats"] if "batch_stats" in variables else False

    @jax.jit
    def forward_and_losses(v, a, s, k):
        res = jmod.apply(v, a, s, k, train=True, mutable=mutable)
        out, upd = res if mutable else (res, None)
        return out, upd, jax_objective(out, s, JaxConfig(latent_levels=2))[1]

    out, upd, want = forward_and_losses(variables, jnp.asarray(x), jnp.asarray(s_oh), key)
    eps = [torch.from_numpy((np.asarray(z) - np.asarray(m)) / np.asarray(s))
           for z, m, s in zip(out.z, out.q_mu, out.q_sigma)]
    tmod.train()
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(s_oh), eps=eps)
        _, got_ld = phiseg_objective(got, torch.from_numpy(s_oh),
                                     ExperimentConfig(latent_levels=2))
    for field in ("s_out_list", "q_mu", "q_sigma", "p_mu", "p_sigma"):
        for i, (w, g) in enumerate(zip(getattr(out, field), getattr(got, field))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"{field}[{i}]",
                                       **MODEL_TOL)
    assert sorted(got_ld) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got_ld[k]), float(want[k]), rtol=1e-3, err_msg=k)
    if upd is not None:
        want_sd = flax_to_state_dict({"params": variables["params"], **upd}, tmod)
        for name, t in tmod.state_dict().items():
            if "brn." in name and not name.endswith(("weight", "bias")):
                np.testing.assert_allclose(t.numpy(), want_sd[name].numpy(), err_msg=name,
                                           **MODEL_TOL)
        assert int(tmod.posterior.tower.level0_conv0.brn.steps) == 3001


def test_batch_renorm_schedule_matches_jax():
    """Three training calls with explicit steps 0, 1000 and 5000 (rmax 1 /
    dmax 0, mid-schedule, both clips at their ends), then a self-counting
    call and an eval call: outputs, running statistics and steps."""
    rng = np.random.RandomState(3)
    c = 6
    jmod = JaxBatchRenorm()
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                            "bias": rng.randn(c).astype(np.float32)},
                 "batch_stats": {"mean": rng.randn(c).astype(np.float32),
                                 "var": rng.uniform(0.1, 0.5, c).astype(np.float32),
                                 "steps": np.asarray(0, np.int32)}}
    tmod = BatchRenorm(c)
    tmod.load_state_dict({"weight": torch.from_numpy(variables["params"]["scale"]),
                          "bias": torch.from_numpy(variables["params"]["bias"]),
                          "running_mean": torch.from_numpy(variables["batch_stats"]["mean"]),
                          "running_var": torch.from_numpy(variables["batch_stats"]["var"]),
                          "steps": torch.tensor(0, dtype=torch.int32)})
    tmod.train()
    for step in (0, 1000, 5000, None):
        x = (2.0 * rng.randn(4, 5, 5, c) + 1.5).astype(np.float32)
        want, upd = jmod.apply(variables, jnp.asarray(x), train=True, step=step,
                               mutable=["batch_stats"])
        variables = {"params": variables["params"],
                     "batch_stats": jax.tree_util.tree_map(np.asarray, upd["batch_stats"])}
        got = tmod(to_nchw(x), step=step)
        np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **TOL, err_msg=str(step))
        bs = variables["batch_stats"]
        np.testing.assert_allclose(tmod.running_mean.numpy(), bs["mean"], **TOL)
        np.testing.assert_allclose(tmod.running_var.numpy(), bs["var"], **TOL)
        assert int(tmod.steps) == int(bs["steps"]) and tmod.steps.dtype == torch.int32
    assert int(tmod.steps) == 4
    x = rng.randn(2, 5, 5, c).astype(np.float32)
    want = jmod.apply(variables, jnp.asarray(x), train=False)
    tmod.eval()
    np.testing.assert_allclose(to_nhwc(tmod(to_nchw(x))), np.asarray(want), **TOL)
    assert int(tmod.steps) == 4  # an eval call does not count


def test_batch_renorm_clips_r_and_d_at_the_schedule():
    """At step 0 (rmax 1, dmax 0) training normalises by the running
    statistics' sigma and mean: r = sigma_B / sigma_R clipped to 1 and d to
    0, so the output is the plain batch-normalised input."""
    bn = BatchRenorm(3)
    with torch.no_grad():
        bn.running_mean.fill_(5.0)
        bn.running_var.fill_(9.0)
    x = torch.randn(4, 3, 6, 6, generator=torch.Generator().manual_seed(0))
    y = bn(x, step=0)
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    torch.testing.assert_close(y, (x - mean) / torch.sqrt(var + 1e-3), rtol=1e-5, atol=1e-5)


RN_WORLD, RN_C = 2, 5


def _renorm_rank(x, gy, state):
    """One rank of the mesh renorm test (runs in a spawned process)."""
    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    bn = BatchRenorm(RN_C)
    bn.load_state_dict(state)
    tl.set_batch_norm_mesh(bn, mesh)
    xb = shard_array(x, mesh).clone().requires_grad_(True)
    y = bn(xb, step=3000)
    (y * shard_array(gy, mesh)).sum().backward()
    return dict(y=y.detach(), gx=xb.grad, gw=bn.weight.grad, gb=bn.bias.grad,
                mean=bn.running_mean.clone(), var=bn.running_var.clone(), steps=bn.steps.clone())


def test_batch_renorm_on_two_ranks_equals_one_rank_on_the_global_batch():
    """Under a mesh the batch statistics are global: 2 gloo ranks, each on
    half of the batch, give the 1-rank outputs, input gradients, running
    statistics and steps; the parameter gradients summed over the ranks are
    the 1-rank ones (the train step then averages the ranks' gradients)."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn(4, RN_C, 6, 6, generator=g) * 2 + 1
    gy = torch.randn(4, RN_C, 6, 6, generator=g)
    ref = BatchRenorm(RN_C)
    with torch.no_grad():
        ref.running_mean.copy_(torch.randn(RN_C, generator=g))
        ref.running_var.uniform_(0.2, 0.6, generator=g)
        ref.weight.uniform_(0.5, 1.5, generator=g)
    state = {k: v.clone() for k, v in ref.state_dict().items()}
    xr = x.clone().requires_grad_(True)
    y = ref(xr, step=3000)
    (y * gy).sum().backward()
    outs = spawn_ranks(_renorm_rank, RN_WORLD, (x, gy, state), backend="gloo", timeout=120)
    torch.testing.assert_close(torch.cat([o["y"] for o in outs]), y.detach(), **TOL)
    torch.testing.assert_close(torch.cat([o["gx"] for o in outs]), xr.grad, **TOL)
    torch.testing.assert_close(sum(o["gw"] for o in outs), ref.weight.grad, **TOL)
    torch.testing.assert_close(sum(o["gb"] for o in outs), ref.bias.grad, **TOL)
    for o in outs:
        torch.testing.assert_close(o["mean"], ref.running_mean, **TOL)
        torch.testing.assert_close(o["var"], ref.running_var, **TOL)
        assert int(o["steps"]) == 1


@pytest.mark.parametrize("name", ["he_normal", "he_uniform", "xavier_normal",
                                  "xavier_uniform", "caffe_uniform"])
def test_weight_init_registry_by_distribution(name):
    """Each initialiser's std and bounds against Flax's: the same
    variance_scaling law (fan_in / fan_avg, truncated normal at 2 std or
    uniform), held on 64x64x3x3 kernels by the sample std (within 3%) and
    the bound (exact)."""
    shape_oihw, shape_hwio = (64, 64, 3, 3), (3, 3, 64, 64)
    w = torch.empty(shape_oihw)
    tl.get_weight_init(name)(w, torch.Generator().manual_seed(0))
    want = np.asarray(jl.get_weight_init(name)(jax.random.PRNGKey(0), shape_hwio))
    fan_in = fan_out = 64 * 9
    fan = fan_in if name in ("he_normal", "he_uniform", "caffe_uniform") else (fan_in + fan_out) / 2
    var = (2.0 if name.startswith("he") else 1.0) / fan
    if name.endswith("normal"):
        bound = 2 * np.sqrt(var) / 0.87962566103423978
    else:
        bound = np.sqrt(3 * var)
    for sample in (w.numpy(), want):
        assert abs(sample.std() - np.sqrt(var)) < 0.03 * np.sqrt(var)
        assert np.abs(sample).max() <= bound * (1 + 1e-6)
        assert np.abs(sample).max() > 0.95 * bound
    with pytest.raises(ValueError):
        tl.get_weight_init("bogus")


def test_bilinear_init_is_exact():
    for shape_hwio in ((4, 4, 3, 3), (3, 3, 2, 4), (5, 4, 3, 2)):
        want = np.asarray(jl.get_weight_init("bilinear")(jax.random.PRNGKey(0), shape_hwio))
        w = torch.full(tuple(shape_hwio[i] for i in (3, 2, 0, 1)), 7.0)
        tl.get_weight_init("bilinear")(w, torch.Generator())
        np.testing.assert_array_equal(w.numpy().transpose(2, 3, 1, 0), want)


def test_conv_block_weight_init_and_instance_params():
    """init_weights_ draws each block's kernel by its own weight_init and
    instance norm's in_scale from N(0, 0.02), in_offset 0."""
    blk = tl.ConvBlock(64, 64, norm="instance", weight_init="bilinear")
    tl.init_weights_(blk, torch.Generator().manual_seed(0))
    want = np.asarray(jl.get_weight_init("bilinear")(jax.random.PRNGKey(0), (3, 3, 64, 64)))
    np.testing.assert_array_equal(blk.conv.weight.detach().numpy().transpose(2, 3, 1, 0), want)
    assert float(blk.conv.bias.abs().max()) == 0.0
    assert float(blk.in_offset.abs().max()) == 0.0
    assert 0.015 < float(blk.in_scale.std()) < 0.025


def test_dropout_keeps_and_scales_in_training_only():
    """Eval mode: the block without dropout. Training: each activation kept
    with the keep-probability and scaled by 1/keep, the mask drawn from the
    generator given (the same generator state gives the same mask); no
    generator raises, as Flax's Dropout without a 'dropout' rng does."""
    x = torch.randn(4, 8, 16, 16, generator=torch.Generator().manual_seed(1))
    blk = tl.ConvBlock(8, 16, activation=None, dropout_keep_prob=0.7)
    plain = tl.ConvBlock(8, 16, activation=None)
    plain.load_state_dict(blk.state_dict())
    blk.eval()
    assert torch.equal(blk(x), plain(x))
    blk.train()
    ref = plain(x)
    y = blk(x, generator=torch.Generator().manual_seed(2))
    kept = y != 0
    rate = float(kept.float().mean())
    n = y.numel()
    assert abs(rate - 0.7) < 5 * np.sqrt(0.7 * 0.3 / n)
    torch.testing.assert_close(y[kept], ref[kept] / 0.7)
    assert torch.equal(y, blk(x, generator=torch.Generator().manual_seed(2)))
    with pytest.raises(ValueError, match="generator"):
        blk(x)


def test_activations_match_jax():
    x = np.random.RandomState(5).randn(50).astype(np.float32) * 3
    for alpha in (0.01, 0.2):
        np.testing.assert_allclose(tact.leaky_relu(torch.from_numpy(x), alpha).numpy(),
                                   np.asarray(jact.leaky_relu(jnp.asarray(x), alpha)), **TOL)
    np.testing.assert_allclose(tact.leaky_relu(torch.tensor([-2.0, 0.0, 3.0])).numpy(),
                               [-0.02, 0.0, 3.0])
    for tf, jf in ((tact.relu, jact.relu), (tact.softplus, jact.softplus),
                   (tact.identity, jact.identity)):
        np.testing.assert_allclose(tf(torch.from_numpy(x)).numpy(), np.asarray(jf(jnp.asarray(x))),
                                   **TOL)


def _logits_labels(seed=6, b=3, hw=8, c=3):
    rng = np.random.RandomState(seed)
    logits = (2 * rng.randn(b, hw, hw, c)).astype(np.float32)
    labels = rng.randint(0, c, (b, hw, hw))
    labels[0] = 0  # an image without foreground
    return logits, np.eye(c, dtype=np.float32)[labels]


@pytest.mark.parametrize("case", [
    ("get_dice", {}),
    ("dice_loss", {"mode": "micro"}),
    ("dice_loss", {"mode": "micro", "only_foreground": True}),
    ("dice_loss", {"mode": "macro"}),
    ("dice_loss", {"mode": "macro", "only_foreground": True}),
    ("dice_loss", {"mode": "macro_robust"}),
    ("dice_loss", {"mode": "macro_robust", "only_foreground": True}),
    ("cross_entropy_loss", {}),
    ("pixel_wise_cross_entropy_loss_weighted", {"class_weights": [0.2, 1.0, 3.0]}),
])
def test_library_losses_match_jax(case):
    name, kw = case
    logits, labels_oh = _logits_labels()
    want = getattr(jlosses, name)(jnp.asarray(logits), jnp.asarray(labels_oh), **kw)
    got = getattr(tlosses, name)(torch.from_numpy(logits), torch.from_numpy(labels_oh), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dice_loss_unknown_mode_raises():
    logits, labels_oh = _logits_labels()
    with pytest.raises(ValueError, match="unknown dice mode"):
        tlosses.dice_loss(torch.from_numpy(logits), torch.from_numpy(labels_oh), mode="bogus")
