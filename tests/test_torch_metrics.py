"""The port's metrics vs phiseg_tpu.metrics on the CPU, on identical seeded
masks and probabilities.

Tolerances: IoU-derived values (distances, GED^2, its terms) and Dice at
rtol 1e-6: the counts are exact on both sides and the f32 arithmetic after
them is the same, only the order of the sums over pairs may differ. S_NCC
and NCC at rtol 1e-5: their maps are f32 sums over draws and classes taken
in another order than jnp.einsum's, and the normalisation divides by a std.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiseg_tpu import metrics as jm
from phiseg_tpu_torch import metrics as tm

torch.set_num_threads(1)
IOU = dict(rtol=1e-6, atol=1e-7)
NCC = dict(rtol=1e-5, atol=1e-6)


def _masks(seed, shape, nlabels=2, p=0.6):
    rng = np.random.RandomState(seed)
    if nlabels == 2:
        return (rng.rand(*shape) > p).astype(np.int32)
    return rng.randint(0, nlabels, shape).astype(np.int32)


@pytest.fixture
def masks():
    """6 samples and 4 annotations with an all-background one on each side
    (the edge cases of tests/test_metrics.py)."""
    samples, gts = _masks(0, (6, 16, 16)), _masks(1, (4, 16, 16))
    samples[2] = 0
    gts[1] = 0
    return samples, gts


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("label_range,divisor", [((1,), None), ((1,), 1), ((0, 1), 2),
                                                 ((1,), 2)])
def test_pairwise_iou_distance_matches_jax(masks, label_range, divisor):
    samples, gts = masks
    want = jm.pairwise_iou_distance(jnp.asarray(samples), jnp.asarray(gts), label_range, divisor)
    got = tm.pairwise_iou_distance(_t(samples), _t(gts), label_range, divisor)
    assert got.dtype == torch.float32 and got.shape == (6, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **IOU)


def test_pairwise_iou_edge_cases():
    a = torch.tensor([[[1, 1], [0, 0]], [[0, 0], [0, 0]]])
    b = torch.tensor([[[0, 0], [0, 0]]])
    d = tm.pairwise_iou_distance(a, b, label_range=(1,))
    # a[0] non-empty vs b empty -> IoU 0 -> distance 1; both empty -> IoU 1 -> 0
    np.testing.assert_array_equal(d[:, 0].numpy(), [1.0, 0.0])


@pytest.mark.parametrize("nlabels,label_range", [(1, (1,)), (2, (1, 2)), (2, None), (3, None)])
def test_ged_and_terms_match_jax(nlabels, label_range):
    """The nlabels-divisor quirk: validation passes nlabels-1 with
    label_range 1..nlabels-1, so (1, (1,)) is the binary case; (2, (1, 2))
    divides a 3-class IoU sum by 2."""
    ncls = 3 if label_range == (1, 2) or nlabels == 3 else 2
    samples, gts = _masks(2, (5, 8, 8), ncls), _masks(3, (3, 8, 8), ncls)
    want = jm.generalised_energy_distance(jnp.asarray(samples), jnp.asarray(gts), nlabels,
                                          label_range)
    got = tm.generalised_energy_distance(_t(samples), _t(gts), nlabels, label_range)
    np.testing.assert_allclose(float(got), float(want), **IOU)
    want_terms = jm.ged_terms(jnp.asarray(samples), jnp.asarray(gts), nlabels, label_range)
    got_terms = tm.ged_terms(_t(samples), _t(gts), nlabels, label_range)
    for g, w in zip(got_terms, want_terms):
        np.testing.assert_allclose(float(g), float(w), **IOU)
    np.testing.assert_allclose(float(2 * got_terms[0] - got_terms[1] - got_terms[2]),
                               float(got), rtol=1e-5, atol=1e-6)


def test_ged_batched_equals_per_image(masks):
    """Leading batch axes: (B, N, H, W) vs (B, M, H, W) -> (B,), each entry
    the JAX value of its image."""
    samples = np.stack([_masks(10 + i, (6, 16, 16)) for i in range(3)])
    gts = np.stack([_masks(20 + i, (4, 16, 16)) for i in range(3)])
    samples[1, :] = 0  # an image whose every sample is empty
    got = tm.generalised_energy_distance(_t(samples), _t(gts), 1, (1,))
    terms = tm.ged_terms(_t(samples), _t(gts), 1, (1,))
    assert got.shape == (3,) and all(t.shape == (3,) for t in terms)
    for i in range(3):
        want = jm.generalised_energy_distance(jnp.asarray(samples[i]), jnp.asarray(gts[i]), 1,
                                              (1,))
        np.testing.assert_allclose(float(got[i]), float(want), **IOU)
        for g, w in zip(terms, jm.ged_terms(jnp.asarray(samples[i]), jnp.asarray(gts[i]), 1,
                                            (1,))):
            np.testing.assert_allclose(float(g[i]), float(w), **IOU)


def test_ged_of_identical_sets_is_zero():
    m = _t(_masks(4, (8, 8, 8), p=0.5))
    np.testing.assert_allclose(float(tm.generalised_energy_distance(m, m, 1, (1,))), 0.0,
                               atol=1e-6)


def test_ged_counts_are_exact_at_128x128():
    """Intersections of 128x128 masks reach 16384 pixels, past what a bf16
    product returns exactly (256); the f64 product keeps them exact under
    bf16 autocast too."""
    samples, gts = _masks(5, (4, 128, 128), p=0.05), _masks(6, (3, 128, 128), p=0.05)
    want = jm.ged_terms(jnp.asarray(samples), jnp.asarray(gts), 1, (1,))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = tm.ged_terms(_t(samples), _t(gts), 1, (1,))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(w), **IOU)


@pytest.mark.parametrize("zero_norm", [True, False])
def test_ncc_matches_jax_with_the_population_std(zero_norm):
    rng = np.random.RandomState(7)
    a, v = rng.rand(8, 8).astype(np.float32), rng.rand(8, 8).astype(np.float32)
    want = jm.ncc(jnp.asarray(a), jnp.asarray(v), zero_norm)
    got = tm.ncc(_t(a), _t(v), zero_norm)
    np.testing.assert_allclose(float(got), float(want), **NCC)
    # ddof 0: numpy's std, not torch's default unbiased one
    an, vn = a.ravel(), v.ravel()
    ref = np.sum((an - an.mean()) / (an.std() * an.size) * (vn - vn.mean()) / vn.std())
    if zero_norm:
        np.testing.assert_allclose(float(got), ref, rtol=1e-5)
    np.testing.assert_allclose(float(tm.ncc(_t(a), _t(a))), 1.0, rtol=1e-5)


def _probs(seed, shape):
    logits = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)


@pytest.mark.parametrize("nclass", [2, 3])
def test_variance_ncc_dist_matches_jax(nclass):
    rng = np.random.RandomState(8)
    probs = _probs(9, (6, 8, 8, nclass))
    gts = np.eye(nclass, dtype=np.float32)[rng.randint(0, nclass, (3, 8, 8))]
    want = jm.variance_ncc_dist(jnp.asarray(probs), jnp.asarray(gts))
    got = tm.variance_ncc_dist(_t(probs), _t(gts))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **NCC)


def test_variance_ncc_dist_batched_and_under_autocast():
    rng = np.random.RandomState(10)
    probs = _probs(11, (3, 5, 16, 16, 2))
    gts = np.eye(2, dtype=np.float32)[(rng.rand(3, 4, 16, 16) > 0.5).astype(int)]
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = tm.variance_ncc_dist(_t(probs), _t(gts))
    assert got.shape == (3,) and got.dtype == torch.float32
    for i in range(3):
        want = jm.variance_ncc_dist(jnp.asarray(probs[i]), jnp.asarray(gts[i]))
        np.testing.assert_allclose(float(got[i]), float(want), **NCC)


def test_dice_edge_cases_and_value():
    zero = torch.zeros(2, 2, dtype=torch.int64)
    np.testing.assert_array_equal(tm.dice_per_label(zero, zero, 2).numpy(), [1.0, 1.0])
    gt = torch.tensor([[1, 0], [0, 0]])
    assert float(tm.dice_per_label(zero, gt, 2)[1]) == 0.0  # one empty -> 0
    pred = torch.tensor([[1, 1], [0, 0]])
    np.testing.assert_allclose(float(tm.dice_per_label(pred, gt, 2)[1]), 2 / 3, rtol=1e-6)


@pytest.mark.parametrize("nlabels", [2, 3])
def test_dice_batched_matches_jax(nlabels):
    pred, gt = _masks(12, (4, 16, 16), nlabels), _masks(13, (4, 16, 16), nlabels)
    pred[0] = 0
    gt[0] = 0  # both foregrounds empty
    gt[1] = 0  # one empty
    want = jm.dice_per_label(jnp.asarray(pred), jnp.asarray(gt), nlabels)
    got = tm.dice_per_label(_t(pred), _t(gt), nlabels)
    assert got.shape == (4, nlabels) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **IOU)


def test_variance_ncc_dist_is_undefined_exactly_where_a_map_has_no_spread():
    """Draws saturated to exactly 0 and 1 make E_ss constant (image 1), or
    spread by ~1e-29 so that its f32 std underflows to 0 (image 2): S_NCC is
    0/0 there, as in the JAX package, and finite where both maps spread."""
    rng = np.random.RandomState(12)
    gts = np.eye(2, dtype=np.float32)[(rng.rand(3, 4, 16, 16) > 0.5).astype(int)]
    probs = _probs(13, (3, 5, 16, 16, 2))
    hard = np.eye(2, dtype=np.float32)[(rng.rand(16, 16) > 0.5).astype(int)]
    probs[1] = hard
    probs[2] = hard
    probs[2, :, :4, :, 1] = np.where(hard[:4, :, 1] == 0, 1e-30, 1.0)
    e_ss, e_sy = tm.variance_ncc_maps(_t(probs), _t(gts))
    assert e_ss.shape == (3, 16, 16) and e_sy.shape == (3, 4, 16, 16)
    maps = torch.cat([e_ss.unsqueeze(1), e_sy], 1).flatten(-2)
    no_spread = (tm.population_std(maps).squeeze(-1) == 0).any(-1)
    got = tm.variance_ncc_dist(_t(probs), _t(gts))
    want = np.array([float(jm.variance_ncc_dist(jnp.asarray(probs[i]), jnp.asarray(gts[i])))
                     for i in range(3)])
    assert (maps[2, 0].amax() > maps[2, 0].amin()).item()  # not constant, yet no spread
    assert no_spread.tolist() == [False, True, True]
    assert (~torch.isfinite(got)).tolist() == no_spread.tolist() == (~np.isfinite(want)).tolist()
    np.testing.assert_allclose(float(got[0]), want[0], **NCC)
