"""The port's on-device augmentation vs phiseg_tpu.data.augment_device on the CPU.

The random draws cannot match (threefry vs torch), so the apply step is held
against the reference on the SAME coordinates / parameters, and the draws
are held by their rates. The elastic field's bicubic upsampling is held
against jax.image.resize itself, to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiseg_tpu.data.augment_device import _augment_one, _bilinear_warp
from phiseg_tpu_torch.data import augment_device as ta

torch.set_num_threads(1)
OPTS = {"do_fliplr": True, "do_flipud": True, "do_rotations": True, "do_scaleaug": True,
        "augment_every_nth": 2}
ELASTIC_OPTS = dict(OPTS, do_elasticaug=True)


def _image(b=2, h=12, w=10, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, 1).astype(np.float32)
    s_oh = np.eye(2, dtype=np.float32)[(rng.rand(b, h, w) > 0.5).astype(np.int64)]
    return x, s_oh


def test_bilinear_warp_matches_reference():
    """Same float coordinates, including integer ones, the exact edges h-1 /
    w-1 and coordinates outside the image (zero fill). The two compute the
    same weights and products; XLA's dot adds the two weighted terms with a
    fused multiply-add, so a result may differ in its last bit or two:
    atol 1e-6 on O(1) values (measured 2.4e-7)."""
    b, h, w = 2, 12, 10
    img = np.random.RandomState(1).randn(b, h, w, 3).astype(np.float32)
    rng = np.random.RandomState(2)
    ys = rng.uniform(-2, h + 1, (b, h, w)).astype(np.float32)
    xs = rng.uniform(-2, w + 1, (b, h, w)).astype(np.float32)
    ys[0, :3, :3], xs[0, :3, :3] = 4.0, 3.0
    ys[1, 0, :], xs[1, :, 0] = h - 1.0, w - 1.0
    want = np.stack([np.asarray(_bilinear_warp(jnp.asarray(img[i]), jnp.asarray(ys[i]),
                                               jnp.asarray(xs[i]))) for i in range(b)])
    got = ta.bilinear_warp(torch.from_numpy(img), torch.from_numpy(ys), torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert np.all(got.numpy()[(ys < 0) | (ys > h - 1) | (xs < 0) | (xs > w - 1)] == 0)


def _jax_params(key, h, w, opts):
    """The draws of _augment_one (augment_device.py:68-106) for one key."""
    every_nth = int(opts["augment_every_nth"])
    k_coin, k_rot, k_r, k_px, k_py, k_el, k_flr, k_fud = jax.random.split(key, 8)
    short = min(h, w)
    r = jax.random.randint(k_r, (), max(short - 30, 1), short + 1).astype(jnp.float32)
    flip_p = 1.0 / max(2, every_nth)
    params = {
        "do_geom": jax.random.randint(k_coin, (), 0, every_nth) == 0,
        "angle": jnp.deg2rad(jax.random.uniform(k_rot, (), minval=-10.0, maxval=10.0)),
        "r": r,
        "px": jnp.floor(jax.random.uniform(k_px) * (w - r + 1.0)),
        "py": jnp.floor(jax.random.uniform(k_py) * (h - r + 1.0)),
        "fliplr": jax.random.bernoulli(k_flr, flip_p),
        "flipud": jax.random.bernoulli(k_fud, flip_p),
    }
    if opts.get("do_elasticaug", False):
        params["elastic"] = 10.0 * jax.random.normal(k_el, (2, 3, 3), jnp.float32)
    return params


def _torch_params(key, h, w, opts):
    return {k: torch.from_numpy(np.array(v)).reshape(1, *np.shape(v))
            for k, v in _jax_params(key, h, w, opts).items()}


@pytest.mark.parametrize("opts", [OPTS, ELASTIC_OPTS], ids=["rigid", "elastic"])
@pytest.mark.parametrize("seed", range(6))
def test_augment_one_matches_reference_on_its_draws(seed, opts):
    """The reference's own draws (the elastic field's included) fed to
    coords_from_params + apply_augmentation. atol 1e-5: XLA may contract the
    coordinate arithmetic into FMAs, which moves a sample coordinate by an
    ulp. With the elastic field atol 1e-4: jax.image.resize's f32 field is
    ~1e-5 px from its f64 value (fields of ~20 px; the port's is 3e-6 px
    from it), and the random images change by up to ~4 per px."""
    h = w = 40
    x, s_oh = _image(b=1, h=h, w=w, seed=seed)
    key = jax.random.PRNGKey(seed)
    want_x, want_s = _augment_one(jnp.asarray(x[0]), jnp.asarray(s_oh[0]), key, opts)
    params = _torch_params(key, h, w, opts)
    ys, xs = ta.coords_from_params(params, h, w, opts)
    got_x, got_s = ta.apply_augmentation(torch.from_numpy(x), torch.from_numpy(s_oh), ys, xs,
                                         params["fliplr"], params["flipud"])
    atol = 1e-4 if opts.get("do_elasticaug") else 1e-5
    np.testing.assert_allclose(got_x[0].numpy(), np.asarray(want_x), atol=atol, rtol=0)
    np.testing.assert_allclose(got_s[0].numpy(), np.asarray(want_s), atol=atol, rtol=0)


def test_flips_are_exact_reversals_per_image():
    x, s_oh = _image(b=2)
    flr = torch.tensor([True, False])
    fud = torch.tensor([True, True])
    gx, gs = ta.apply_augmentation(torch.from_numpy(x), torch.from_numpy(s_oh), None, None,
                                   flr, fud)
    np.testing.assert_array_equal(gx[0].numpy(), x[0, ::-1, ::-1])
    np.testing.assert_array_equal(gx[1].numpy(), x[1, ::-1, :])
    np.testing.assert_array_equal(gs[0].numpy(), s_oh[0, ::-1, ::-1])


@pytest.mark.parametrize("every_nth", [1, 2, 5])
def test_gating_rates_from_the_generator(every_nth):
    n, h, w = 20000, 128, 128
    opts = dict(OPTS, augment_every_nth=every_nth)
    p = ta.draw_params(n, h, w, opts, torch.Generator().manual_seed(every_nth))
    flip_p = 1.0 / max(2, every_nth)
    for key, rate in (("do_geom", 1.0 / every_nth), ("fliplr", flip_p), ("flipud", flip_p)):
        sd = np.sqrt(rate * (1 - rate) / n) + 1e-12
        assert abs(float(p[key].float().mean()) - rate) < 5 * sd, key
    assert float(p["angle"].abs().max()) <= np.deg2rad(10.0) + 1e-6
    assert float(p["r"].min()) >= 98 and float(p["r"].max()) <= 128
    assert bool((p["px"] >= 0).all()) and bool((p["px"] <= w - p["r"]).all())


def test_augment_fn_identity_and_label_dtype():
    fn = ta.make_augment_fn({}, nlabels=2)
    x, s_oh = _image()
    s = torch.from_numpy(s_oh.argmax(-1).astype(np.uint8))
    gx, gs = fn(torch.from_numpy(x), s, torch.Generator().manual_seed(0))
    assert torch.equal(gx, torch.from_numpy(x)) and torch.equal(gs, s)
    rot0 = ta.make_augment_fn({"do_rotations": True, "rot_degrees": 0.0,
                               "augment_every_nth": 1}, nlabels=2)
    gx, gs = rot0(torch.from_numpy(x), s, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(gx.numpy(), x, atol=1e-6)
    assert gs.dtype == torch.uint8 and torch.equal(gs, s)
    full = ta.make_augment_fn(OPTS, nlabels=2)
    gx, gs = full(torch.from_numpy(x), s, torch.Generator().manual_seed(0))
    assert gx.shape == x.shape and gs.shape == s.shape and bool(torch.isfinite(gx).all())


@pytest.mark.parametrize("hw", [(32, 32), (128, 128), (12, 10)])
def test_elastic_resize_matrices_match_jax_image_resize(hw):
    """The (H x 3) and (W x 3) bicubic weight matrices are jax.image.resize's
    (Keys a=-0.5, half-pixel centres, border taps renormalised): column k is
    the resize of the k-th unit vector, to 1e-6; and the field they make,
    Wy @ d @ Wx^T per channel, is jax.image.resize of the (3, 3, 2) field to
    1e-6 of its largest value (f32 round-off of either; measured 5e-7)."""
    h, w = hw
    for n in (h, w):
        want = np.stack([np.asarray(jax.image.resize(jnp.eye(3, dtype=jnp.float32)[k], (n,),
                                                     method="bicubic")) for k in range(3)], 1)
        np.testing.assert_allclose(ta.bicubic_resize_matrix(3, n).numpy(), want, atol=1e-6,
                                   rtol=0)
    d = (10.0 * np.random.RandomState(7).randn(2, 2, 3, 3)).astype(np.float32)
    got = ta.elastic_field(torch.from_numpy(d), h, w).numpy()
    for i in range(2):
        want = np.asarray(jax.image.resize(jnp.asarray(d[i].transpose(1, 2, 0)), (h, w, 2),
                                           method="bicubic"))
        np.testing.assert_allclose(got[i].transpose(1, 2, 0), want, atol=1e-6 * np.abs(want).max(), rtol=0)
    # torch's own bicubic is another function (a=-0.75, clamped indices)
    other = torch.nn.functional.interpolate(torch.from_numpy(d), size=hw, mode="bicubic",
                                            align_corners=False).numpy()
    assert np.abs(other - got).max() > 1e-2


@pytest.mark.parametrize("seed", range(2))
def test_elastic_only_augmentation_matches_reference(seed):
    """The elastic warp alone (no rotation or scale), on the reference's
    draws with every_nth 1 (the coin always on), at atol 1e-4 as above; the
    coin set off leaves the image as it was."""
    h, w = 24, 20
    opts = {"do_elasticaug": True, "augment_every_nth": 1}
    x, s_oh = _image(b=1, h=h, w=w, seed=seed)
    key = jax.random.PRNGKey(10 + seed)
    want_x, want_s = _augment_one(jnp.asarray(x[0]), jnp.asarray(s_oh[0]), key, opts)
    params = _torch_params(key, h, w, opts)
    assert bool(params["do_geom"].all())
    ys, xs = ta.coords_from_params(params, h, w, opts)
    got_x, got_s = ta.apply_augmentation(torch.from_numpy(x), torch.from_numpy(s_oh), ys, xs)
    np.testing.assert_allclose(got_x[0].numpy(), np.asarray(want_x), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_s[0].numpy(), np.asarray(want_s), atol=1e-4, rtol=0)
    assert np.abs(got_x.numpy() - x).max() > 1e-2  # the field moved the image
    params["do_geom"] = torch.tensor([False])
    ys, xs = ta.coords_from_params(params, h, w, opts)
    got_x, _ = ta.apply_augmentation(torch.from_numpy(x), torch.from_numpy(s_oh), ys, xs)
    np.testing.assert_allclose(got_x.numpy(), x, atol=1e-6)


def test_elastic_draws_and_augment_fn():
    """make_augment_fn with the elastic field: its draw is N(0, 10) per
    (image, channel, knot), and the batch function is its parts."""
    p = ta.draw_params(4000, 32, 32, ELASTIC_OPTS, torch.Generator().manual_seed(0))
    assert p["elastic"].shape == (4000, 2, 3, 3)
    assert abs(float(p["elastic"].std()) - 10.0) < 0.2 and abs(float(p["elastic"].mean())) < 0.2
    assert "elastic" not in ta.draw_params(4, 32, 32, OPTS, torch.Generator().manual_seed(0))
    x, s_oh = _image(b=3, h=16, w=16)
    s = torch.from_numpy(s_oh.argmax(-1).astype(np.uint8))
    gx, gs = ta.make_augment_fn(ELASTIC_OPTS, nlabels=2)(torch.from_numpy(x), s,
                                                         torch.Generator().manual_seed(1))
    p = ta.draw_params(3, 16, 16, ELASTIC_OPTS, torch.Generator().manual_seed(1))
    ys, xs = ta.coords_from_params(p, 16, 16, ELASTIC_OPTS)
    wx, ws = ta.apply_augmentation(torch.from_numpy(x), torch.from_numpy(s_oh), ys, xs,
                                   p["fliplr"], p["flipud"])
    assert torch.equal(gx, wx) and torch.equal(gs, ws.argmax(-1).to(torch.uint8))
