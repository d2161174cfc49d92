"""The fused residual CE: the port's plain version vs the JAX Pallas kernel
(run in interpret mode on the CPU, as tests/test_pallas_ops.py runs it), and
the CUDA kernels vs the plain version where a card is present.

Tolerances: f32 forward rtol 1e-5 and gradient rtol 1e-4 / atol 1e-6, the
same as tests/test_pallas_ops.py (sums over a few hundred pixels in another
order); bf16 rtol 2e-2 (the levels are accumulated in bf16 by the plain
version and in f32 by the kernels, scripts/pallas_tpu_parity.py).

The JAX package is imported inside the tests that compare with it, so that
the CUDA cases also run on a machine with a card and no jax:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_fused_ce.py
"""

import numpy as np
import pytest
import torch

from phiseg_tpu_torch.ops import fused_residual_ce as frce

torch.set_num_threads(1)


def _case(levels, b, hw, c=2, seed=0):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(levels, b, hw, hw, c) * 3.0).astype(np.float32)
    s_oh = np.eye(c, dtype=np.float32)[(rng.rand(b, hw, hw) > 0.6).astype(np.int64)]
    return logits, s_oh


@pytest.mark.parametrize("levels,b,hw", [(1, 2, 16), (3, 2, 16), (5, 2, 8), (3, 3, 10)])
def test_plain_forward_and_weighted_gradient_match_pallas(levels, b, hw):
    import jax
    import jax.numpy as jnp
    from phiseg_tpu.ops.fused_residual_ce import fused_residual_ce as jax_fused

    logits, s_oh = _case(levels, b, hw, seed=levels)
    w = np.linspace(0.5, 2.0, levels).astype(np.float32)
    tile = 256  # P = 300 at (3, 3, 10): not a multiple of the tile
    want = jax_fused(jnp.asarray(logits), jnp.asarray(s_oh), tile)
    want_g = jax.grad(lambda lg: jnp.sum(jnp.asarray(w) * jax_fused(lg, jnp.asarray(s_oh), tile)))(
        jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_(True)
    got = frce.fused_residual_ce(lg, torch.from_numpy(s_oh))  # CPU -> the plain version
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(lg.grad.numpy(), np.asarray(want_g), rtol=1e-4, atol=1e-6)


def test_plain_bf16_matches_pallas():
    import jax.numpy as jnp
    from phiseg_tpu.ops.fused_residual_ce import fused_residual_ce as jax_fused

    logits, s_oh = _case(2, 2, 8, seed=5)
    want = jax_fused(jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(s_oh), 256)
    got = frce.fused_residual_ce(torch.from_numpy(logits).to(torch.bfloat16),
                                 torch.from_numpy(s_oh))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), rtol=2e-2)


def test_weights_one_level_sum_is_the_plain_loop():
    """Level i is CE of sum_{j>=i} logits_j: check level 0 and L-1 by hand."""
    logits, s_oh = _case(3, 2, 4, seed=7)
    lg, so = torch.from_numpy(logits), torch.from_numpy(s_oh)
    per_level = frce.residual_ce_plain(lg, so)

    def ce(acc):
        return -(so * torch.log_softmax(acc, -1)).sum(-1).reshape(2, -1).sum(1).mean()

    torch.testing.assert_close(per_level[2], ce(lg[2]))
    torch.testing.assert_close(per_level[0], ce(lg[0] + lg[1] + lg[2]))


def test_cpu_tensors_take_the_plain_version_without_launching():
    frce.reset_launch_counts()
    logits, s_oh = _case(2, 2, 4)
    frce.fused_residual_ce(torch.from_numpy(logits), torch.from_numpy(s_oh))
    assert frce.LAUNCHES == {"fused_residual_ce_fwd": 0, "fused_residual_ce_bwd": 0,
                             "fused_residual_ce_dp": 0}


def test_kernel_entry_points_refuse_cpu_tensors():
    logits, s_oh = _case(2, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        frce.fused_residual_ce_forward(torch.from_numpy(logits), torch.from_numpy(s_oh))
    with pytest.raises(ValueError, match=r"\(L,B,H,W,C\)"):
        frce.fused_residual_ce_forward(torch.from_numpy(logits[0]), torch.from_numpy(s_oh))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-4, 1e-5), ("bfloat16", 2e-2, 5e-2)])
def test_cuda_kernels_match_plain_version(dtype, rtol, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    dt = getattr(torch, dtype)
    logits, s_oh = _case(5, 12, 128, seed=1)
    lg = torch.from_numpy(logits).cuda().to(dt)
    so = torch.from_numpy(s_oh).cuda()
    w = torch.tensor([1.0, 2.0, 0.5, 1.0, 3.0], device="cuda")
    a = lg.clone().requires_grad_(True)
    out = frce.fused_residual_ce(a, so)
    (out * w).sum().backward()
    b = lg.clone().requires_grad_(True)
    ref = frce.residual_ce_plain(b, so)
    (ref * w).sum().backward()
    torch.testing.assert_close(out, ref.detach(), rtol=rtol, atol=0.0)
    torch.testing.assert_close(a.grad.float(), b.grad.float(), rtol=0.0, atol=atol)
    assert a.grad.dtype == dt
    assert torch.equal(frce.fused_residual_ce_forward(lg, so), frce.fused_residual_ce_forward(lg, so))
