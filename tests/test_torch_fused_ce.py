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
    # class 0 for 60% of the pixels, the others share the rest
    labels = np.searchsorted(np.linspace(0.6, 1.0, c)[:-1], rng.rand(b, hw, hw))
    s_oh = np.eye(c, dtype=np.float32)[labels]
    return logits, s_oh


def _as_form(logits, form):
    """The (L,B,H,W,C) tensor `logits` as the kernels' callers hand it over:
    one stacked leaf; L NCHW leaves (B,C,H,W) seen through NHWC views
    ("levels"); or L leaves contiguous in NHWC ("rows"), as the model's
    channels-last likelihood hands its levels out; "rows+1" the same one
    element off an aligned address. Returns (input, leaves)."""
    if form == "stacked":
        lg = logits.clone().requires_grad_(True)
        return lg, [lg]
    if form == "rows":
        leaves = [lv.contiguous().requires_grad_(True) for lv in logits]
        return leaves, leaves
    if form == "rows+1":
        leaves = [torch.empty(lv.numel() + 1, dtype=lv.dtype, device=lv.device)[1:].view(lv.shape)
                  .copy_(lv).requires_grad_(True) for lv in logits]
        return leaves, leaves
    leaves = [lv.permute(0, 3, 1, 2).contiguous().requires_grad_(True) for lv in logits]
    return [t.permute(0, 2, 3, 1) for t in leaves], leaves


def _leaf_grads_nhwc(leaves, form):
    """The leaves' gradients as one (L,B,H,W,C) tensor."""
    if form == "stacked":
        return leaves[0].grad
    return torch.stack([t.grad if form.startswith("rows") else t.grad.permute(0, 2, 3, 1)
                        for t in leaves])


@pytest.mark.parametrize("form", ["stacked", "levels", "rows"])
@pytest.mark.parametrize("levels,b,hw", [(1, 2, 16), (3, 2, 16), (5, 2, 8), (3, 3, 10)])
def test_plain_forward_and_weighted_gradient_match_pallas(levels, b, hw, form):
    import jax
    import jax.numpy as jnp
    from phiseg_tpu.ops.fused_residual_ce import fused_residual_ce as jax_fused

    logits, s_oh = _case(levels, b, hw, seed=levels)
    w = np.linspace(0.5, 2.0, levels).astype(np.float32)
    tile = 256  # P = 300 at (3, 3, 10): not a multiple of the tile
    want = jax_fused(jnp.asarray(logits), jnp.asarray(s_oh), tile)
    want_g = jax.grad(lambda lg: jnp.sum(jnp.asarray(w) * jax_fused(lg, jnp.asarray(s_oh), tile)))(
        jnp.asarray(logits))
    inp, leaves = _as_form(torch.from_numpy(logits), form)
    got = frce.fused_residual_ce(inp, torch.from_numpy(s_oh))  # CPU -> the plain version
    (got * torch.from_numpy(w)).sum().backward()
    assert all(t.grad.shape == t.shape for t in leaves)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(_leaf_grads_nhwc(leaves, form).numpy(), np.asarray(want_g),
                               rtol=1e-4, atol=1e-6)


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
    views, _ = _as_form(torch.from_numpy(logits), "levels")
    with pytest.raises(ValueError, match="CUDA"):
        frce.fused_residual_ce_backward(views, torch.from_numpy(s_oh), torch.ones(2))


def test_levels_nchw_reads_both_layouts_in_place_and_copies_the_rest():
    """NHWC views of NCHW tensors, levels contiguous in NHWC and the stacked
    form's levels reach the kernels as views of the caller's storage; a
    level in neither layout, or levels in two layouts, are copied into NCHW."""
    logits = torch.from_numpy(_case(3, 2, 8)[0])

    def shares(got, tensors):
        return all(g.data_ptr() == t.data_ptr()
                   and g.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
                   for g, t in zip(got, tensors))

    views, leaves = _as_form(logits, "levels")
    got = frce._levels_nchw(views)
    assert shares(got, leaves) and frce._planes(got)
    assert all(g.is_contiguous() and g.shape == t.shape for g, t in zip(got, leaves))
    rows = [lv.contiguous() for lv in logits]  # NHWC rows, as the channels-last model hands out
    got = frce._levels_nchw(rows)
    assert shares(got, rows) and not frce._planes(got)
    assert all(torch.equal(g, r.permute(0, 3, 1, 2)) for g, r in zip(got, rows))
    got = frce._levels_nchw(logits)
    assert len(got) == 3 and not frce._planes(got)
    assert all(g.untyped_storage().data_ptr() == logits.untyped_storage().data_ptr() for g in got)
    assert all(torch.equal(g, lv.permute(0, 3, 1, 2)) for g, lv in zip(got, logits))
    for mixed in ([views[0], rows[1]], [logits[0][:, ::2]]):
        got = frce._levels_nchw(mixed)
        assert frce._planes(got)
        assert all(torch.equal(g, m.permute(0, 3, 1, 2)) for g, m in zip(got, mixed))
        assert not any(g.untyped_storage().data_ptr() == m.untyped_storage().data_ptr()
                       for g, m in zip(got, mixed) if not m.permute(0, 3, 1, 2).is_contiguous())
    with pytest.raises(ValueError, match=r"\(B,H,W,C\)"):
        frce._levels_nchw([logits])


@pytest.mark.parametrize("hw,offsets,itemsize,label_offset,vector", [
    (128 * 128, (0, 786432, 1572864), 4, 0, True),  # the main path: 128x128 f32 levels
    (9 * 9, (0, 1024), 4, 0, False),                 # H*W not a multiple of 4
    (10 * 10, (0, 1028), 4, 0, False),               # a level 4 bytes off a 16-byte boundary
    (10 * 10, (0, 1032), 2, 0, True),                # bf16: one load is 8 bytes wide
    (10 * 10, (0, 1028), 2, 0, False),
    (10 * 10, (0, 1024), 4, 8, False),               # labels off a 16-byte boundary
])
def test_vector_kernel_choice_follows_plane_size_and_alignment(hw, offsets, itemsize, label_offset,
                                                               vector):
    base = 1 << 30
    assert frce.vector_kernel_fits(hw, [base + o for o in offsets], itemsize,
                                   base + 4096 + label_offset) is vector


@pytest.mark.parametrize("hw,nclass,planes,offsets,itemsize,label_offset,vector", [
    (128 * 128, 2, True, (0, 786432, 1572864), 4, 0, True),  # the main path: f32 planes, 8 B
    (128 * 128, 2, False, (0, 786432), 4, 0, True),          # f32 rows: 16-byte runs
    (9 * 9, 2, True, (0, 1024), 4, 0, False),                # H*W odd
    (10 * 10, 2, True, (0, 1028), 4, 0, False),              # a plane 4 bytes off its 8-byte access
    (10 * 10, 2, False, (4, 1028), 4, 0, False),             # rows one f32 off (rows+1)
    (10 * 10, 2, False, (0, 1032), 4, 0, False),             # rows 8 bytes off a 16-byte access
    (10 * 10, 3, False, (0, 1032), 4, 0, True),              # C=3 rows: 24 B runs, 8 B accesses
    (10 * 10, 3, False, (0, 1028), 4, 0, False),
    (10 * 10, 2, True, (0, 1028), 2, 0, True),               # bf16 planes: 4-byte pairs
    (10 * 10, 2, True, (0, 1026), 2, 0, False),
    (10 * 10, 3, False, (0, 1036), 2, 0, True),              # bf16 C=3 rows: 12-byte runs
    (10 * 10, 4, False, (0, 1040), 2, 0, True),              # bf16 C=4 rows: 16-byte runs
    (10 * 10, 4, False, (0, 1032), 2, 0, False),
    (10 * 10, 1, True, (0, 1032), 4, 8, True),               # C=1 labels: 8-byte runs
    (10 * 10, 2, True, (0, 1024), 4, 8, False),              # C=2 labels: 16-byte runs
])
def test_backward_kernel_choice_follows_plane_size_alignment_and_classes(
        hw, nclass, planes, offsets, itemsize, label_offset, vector):
    base = 1 << 30
    assert frce.backward_vector_fits(hw, nclass, planes, [base + o for o in offsets], itemsize,
                                     base + 4096 + label_offset) is vector


@pytest.mark.parametrize("batch,nclass,hw,refused", [
    (12, 2, 128 * 128, None),                                # the main path
    (frce.MAX_BATCH, 1, 2 ** 31 - 1, None),                  # the largest grid it holds
    (frce.MAX_BATCH + 1, 2, 128 * 128, "at most 65535 images"),
    (1, 4, 2 ** 29, r"at most 2147483647 \(2\^31 - 1\) elements an image"),
])
def test_backward_grid_refuses_what_it_cannot_address(batch, nclass, hw, refused):
    if refused is None:
        frce.check_backward_grid(batch, nclass, hw)
    else:
        with pytest.raises(ValueError, match=refused):
            frce.check_backward_grid(batch, nclass, hw)


def test_autograd_function_routes_each_level_and_its_gradient(monkeypatch):
    """The kernels' autograd wiring on the CPU, with the two launches
    replaced by the plain version on the same NCHW levels: each form reaches
    the Function as L NCHW levels, and each input gets its own gradient in
    its own shape, from K2's output in the backward entry point's form."""

    def launch_forward(levels, s_oh):
        return frce.residual_ce_plain([t.permute(0, 2, 3, 1) for t in levels], s_oh)

    def launch_backward(levels, s_oh, g):
        ls = [t.detach().requires_grad_(True) for t in levels]
        with torch.enable_grad():
            out = launch_forward(ls, s_oh)
        return list(torch.autograd.grad(out, ls, grad_outputs=g))

    monkeypatch.setattr(frce, "_check", lambda levels, s_oh: None)
    monkeypatch.setattr(frce, "_launch_forward", launch_forward)
    monkeypatch.setattr(frce, "_launch_backward", launch_backward)
    logits, s_oh = (torch.from_numpy(a) for a in _case(3, 2, 8, seed=3))
    w = torch.tensor([1.0, 2.0, 0.5])
    ref_in = logits.clone().requires_grad_(True)
    ref = frce.residual_ce_plain(ref_in, s_oh)
    (ref_g,) = torch.autograd.grad(ref, ref_in, grad_outputs=w)
    for form in ("stacked", "levels", "rows"):
        inp, leaves = _as_form(logits, form)
        out = frce._FusedResidualCE.apply(s_oh, *frce._levels_nchw(inp))
        (out * w).sum().backward()
        torch.testing.assert_close(out, ref.detach())
        assert all(t.grad.shape == t.shape for t in leaves)
        torch.testing.assert_close(_leaf_grads_nhwc(leaves, form), ref_g)
        grads = frce.fused_residual_ce_backward(inp, s_oh, w)
        if form == "stacked":
            assert grads.shape == logits.shape
        else:
            assert isinstance(grads, tuple) and [g.shape for g in grads] == [v.shape for v in inp]
        torch.testing.assert_close(torch.stack(list(grads)), ref_g)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["stacked", "levels", "rows", "rows+1"])
@pytest.mark.parametrize("levels,b,hw,c", [
    (5, 12, 128, 2),  # the main path: vector kernels
    (3, 2, 9, 2),     # H*W odd: scalar kernels
    (3, 2, 16, 1), (3, 2, 16, 3), (8, 12, 16, 4),
])
@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-4, 1e-5), ("bfloat16", 2e-2, 5e-2)])
def test_cuda_kernels_match_plain_version(dtype, rtol, atol, levels, b, hw, c, form):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no CPU mode")
    dt = getattr(torch, dtype)
    logits, s_oh = _case(levels, b, hw, c, seed=1)
    lg = torch.from_numpy(logits).cuda().to(dt)
    so = torch.from_numpy(s_oh).cuda()
    w = torch.tensor([1.0, 2.0, 0.5, 1.0, 3.0, 1.0, 0.5, 1.0][:levels], device="cuda")
    inp, leaves = _as_form(lg, form)
    out = frce.fused_residual_ce(inp, so)
    (out * w).sum().backward()
    b_in = lg.clone().requires_grad_(True)
    ref = frce.residual_ce_plain(b_in, so)
    (ref * w).sum().backward()
    torch.testing.assert_close(out, ref.detach(), rtol=rtol, atol=0.0)
    grad = _leaf_grads_nhwc(leaves, form)
    torch.testing.assert_close(grad.float(), b_in.grad.float(), rtol=0.0, atol=atol)
    assert grad.dtype == dt and all(t.grad.shape == t.shape for t in leaves)
    assert torch.equal(frce.fused_residual_ce_forward(inp, so), frce.fused_residual_ce_forward(inp, so))
    assert all(torch.equal(x, y) for x, y in zip(frce.fused_residual_ce_backward(inp, so, w),
                                                  frce.fused_residual_ce_backward(inp, so, w)))
