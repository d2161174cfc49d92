"""The port's objective vs phiseg_tpu.engine.objective.phiseg_objective on the CPU.

Same numpy inputs to both; loss dicts compared key by key. Tolerance rtol
1e-5: f32 reductions over a few hundred values in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiseg_tpu.engine.config import ExperimentConfig as JaxConfig
from phiseg_tpu.engine.objective import phiseg_objective as jax_objective
from phiseg_tpu.engine.objective import residual_multinoulli_loss as jax_residual_ce
from phiseg_tpu.engine.objective import weight_decay_loss as jax_weight_decay
from phiseg_tpu.models import SegVAE as JaxSegVAE
from phiseg_tpu.models.segvae import ModelOutputs as JaxOutputs
from phiseg_tpu_torch.convert import flax_to_state_dict
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.objective import (
    phiseg_objective,
    residual_multinoulli_loss,
    weight_decay_loss,
)
from phiseg_tpu_torch.models import SegVAE
from phiseg_tpu_torch.models.segvae import ModelOutputs
from phiseg_tpu_torch.ops import fused_residual_ce as frce

torch.set_num_threads(1)


def _outputs(L=3, b=2, hw=16, seed=0, tiny_sigma=False):
    rng = np.random.RandomState(seed)
    s_out = [rng.randn(b, hw, hw, 2).astype(np.float32) * 2 for _ in range(L)]
    lat = [(b, hw // 2 ** (i + 1), hw // 2 ** (i + 1), 2) for i in range(L)]
    q_mu = [rng.randn(*s).astype(np.float32) for s in lat]
    p_mu = [rng.randn(*s).astype(np.float32) for s in lat]
    q_sigma = [rng.uniform(0.2, 2.0, s).astype(np.float32) for s in lat]
    p_sigma = [rng.uniform(0.2, 2.0, s).astype(np.float32) for s in lat]
    if tiny_sigma:  # a saturated softplus unit: the +1e-10 guards carry the KL
        p_sigma[0][0, 0, 0, 0] = 0.0
    s_oh = np.eye(2, dtype=np.float32)[(rng.rand(b, hw, hw) > 0.5).astype(np.int64)]
    fields = dict(s_out_list=s_out, z=q_mu, q_mu=q_mu, q_sigma=q_sigma, p_mu=p_mu,
                  p_sigma=p_sigma)
    jo = JaxOutputs(**{k: tuple(jnp.asarray(a) for a in v) for k, v in fields.items()})
    to = ModelOutputs(**{k: tuple(torch.from_numpy(a) for a in v) for k, v in fields.items()})
    return jo, to, s_oh


@pytest.mark.parametrize("use_fused", [False, True])
@pytest.mark.parametrize("kw", [
    {},
    {"exponential_weighting": False},
    {"kl_sigma_floor": 0.5},
    {"kl_divergence_loss_weight": None},
    {"residual_multinoulli_loss_weight": 2.0, "kl_divergence_loss_weight": 0.5},
])
def test_loss_dict_matches_jax(kw, use_fused):
    jo, to, s_oh = _outputs()
    _, want = jax_objective(jo, jnp.asarray(s_oh), JaxConfig(**kw), use_fused_ce=use_fused)
    _, got = phiseg_objective(to, torch.from_numpy(s_oh), ExperimentConfig(**kw),
                              use_fused_ce=use_fused)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_kl_guard_keeps_init_transient_finite():
    """A zero prior sigma gives a ~1e11-scale but finite KL through the
    reference's +1e-10 guards, as in the JAX package at init."""
    jo, to, s_oh = _outputs(tiny_sigma=True)
    _, want = jax_objective(jo, jnp.asarray(s_oh), JaxConfig())
    _, got = phiseg_objective(to, torch.from_numpy(s_oh), ExperimentConfig())
    kl0 = float(got["KL_divergence_loss_lvl0"])
    assert np.isfinite(kl0) and kl0 > 1e8
    np.testing.assert_allclose(kl0, float(want["KL_divergence_loss_lvl0"]), rtol=1e-5)


def test_weight_decay_matches_jax():
    kw = dict(model_family="phiseg", latent_levels=3, resolution_levels=5, n0=4, zdim0=2,
              nlabels=2, image_size=(32, 32), norm="batch")
    jmod = JaxSegVAE(**kw)
    x = jnp.zeros((2, 32, 32, 1))
    shapes = jax.eval_shape(lambda k: jmod.init({"params": k}, x, jnp.zeros((2, 32, 32, 2)), k,
                                                train=True), jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    tmod = SegVAE(**kw)
    tmod.load_state_dict(flax_to_state_dict(variables, tmod))
    want = float(jax_weight_decay(variables["params"]))
    np.testing.assert_allclose(float(weight_decay_loss(tmod)), want, rtol=1e-5)
    jo, to, s_oh = _outputs()
    _, got = phiseg_objective(to, torch.from_numpy(s_oh), ExperimentConfig(weight_decay_weight=1e-4),
                              model=tmod)
    np.testing.assert_allclose(float(got["weight_decay"]), 1e-4 * want, rtol=1e-5)


def test_fused_ce_on_the_models_levels_matches_jax_and_reads_them_in_place():
    """The fused CE on a port model's own s_out_list (NHWC views of the
    likelihood's NCHW-shaped tensors, channels-last in memory here): the
    kernels' inputs are those tensors, not a copy, and the losses and
    gradients match the JAX fused objective."""
    kw = dict(model_family="phiseg", latent_levels=3, resolution_levels=5, n0=4, zdim0=2,
              nlabels=2, image_size=(32, 32), norm="batch")
    torch.manual_seed(0)
    model = SegVAE(**kw, dtype=torch.float32, image_channels=1)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 32, 1).astype(np.float32)
    s_oh = np.eye(2, dtype=np.float32)[(rng.rand(2, 32, 32) > 0.5).astype(np.int64)]
    levels = model(torch.from_numpy(x), torch.from_numpy(s_oh),
                   generator=torch.Generator().manual_seed(0)).s_out_list
    for t, n in zip(levels, frce._levels_nchw(levels)):
        assert n.is_contiguous() or n.is_contiguous(memory_format=torch.channels_last)
        assert n.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
        assert n.data_ptr() == t.data_ptr()
    total, got = residual_multinoulli_loss(levels, torch.from_numpy(s_oh), use_fused=True)
    grads = torch.autograd.grad(total, levels)
    arrays = [jnp.asarray(t.detach().numpy()) for t in levels]
    want_total, want = jax_residual_ce(arrays, jnp.asarray(s_oh), use_fused=True)
    want_g = jax.grad(lambda a: jax_residual_ce(a, jnp.asarray(s_oh), use_fused=True)[0])(arrays)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(total), float(want_total), rtol=1e-5)
    for i, (g, w) in enumerate(zip(grads, want_g)):
        assert g.shape == levels[i].shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6, err_msg=str(i))
