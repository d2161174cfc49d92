"""The port's figure CLIs and result aggregation vs the JAX package on the CPU.

error_maps, the sample-construction arrays (on JAX's noise: eps = (z - mu) /
sigma of the JAX prior draw with the decode's key) and the GIF frames are
held against the JAX CLIs' own arithmetic; each CLI writes its file from a
small trained log dir; `eval_plots.aggregate` of the port gives the JAX
module's results on the same npz files. Tolerances: rtol/atol 1e-5 for the
error maps (f32 einsums in another order), 1e-4 for the construction arrays
(about twenty convolutions in a chain, as tests/test_torch_sampler.py);
frames, masks and aggregates exact or to 1e-12.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from phiseg_tpu.cli import eval_plots as jax_eval_plots
from phiseg_tpu.cli import makegif_samples as jax_gif
from phiseg_tpu.cli.generate_samples import error_maps as jax_error_maps
from phiseg_tpu.engine.train import make_sample_levels_fn as jax_make_sample_levels_fn
from phiseg_tpu.models import SegVAE as JaxSegVAE
from phiseg_tpu_torch.cli import eval_plots, generate_samples, makegif_samples, sample_construction
from phiseg_tpu_torch.cli.train import main as train_main
from phiseg_tpu_torch.convert import flax_to_state_dict
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.train import make_sample_fn, make_sample_levels_fn
from phiseg_tpu_torch.models import SegVAE

torch.set_num_threads(1)
KW = dict(model_family="phiseg", latent_levels=3, resolution_levels=4, n0=4, zdim0=2,
          nlabels=2, image_size=(16, 16), norm="batch")


def test_error_maps_match_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(6, 9, 7, 3).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    gt_oh = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (4, 9, 7))]
    want = jax_error_maps(probs, gt_oh)
    got = generate_samples.error_maps(torch.from_numpy(probs), torch.from_numpy(gt_oh))
    for g, w, name in zip(got, want, ("e_ss", "e_sy", "e_yy")):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def pair():
    """The JAX model and the port's with the same weights, in eval mode."""
    rng = np.random.RandomState(1)
    x = rng.randn(1, 16, 16, 1).astype(np.float32)
    s_oh = np.eye(2, dtype=np.float32)[(rng.rand(1, 16, 16) > 0.6).astype(np.int64)]
    jmod = JaxSegVAE(**KW)
    shapes = jax.eval_shape(lambda k: jmod.init({"params": k}, jnp.asarray(x), jnp.asarray(s_oh),
                                                k, train=True), jax.random.PRNGKey(0))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*leaf.shape) * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.3 * rng.randn(*leaf.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    tmod = SegVAE(**KW, dtype=torch.float32, image_channels=1)
    tmod.load_state_dict(flax_to_state_dict(variables, tmod))
    return x, jmod, variables, tmod.eval()


def _jax_noise(jmod, variables, x, key):
    z, mu, sigma = jmod.apply(variables, jnp.asarray(x), key, method="prior_draw")
    return [torch.from_numpy((np.asarray(a) - np.asarray(m)) / np.asarray(s))[None]
            for a, m, s in zip(z, mu, sigma)]


def test_construction_arrays_on_jax_noise(pair):
    """JAX sample_construction.py:54-66 on its own draw, coarsest level
    first: the residual's last-minus-first logit, the accumulated argmax and
    the accumulated softmax's last class."""
    x, jmod, variables, tmod = pair
    rng = jax.random.PRNGKey(5)
    levels = [np.asarray(t)[0, 0] for t in
              jax_make_sample_levels_fn(jmod, 1)(variables, jnp.asarray(x), rng)]
    eps = _jax_noise(jmod, variables, x, jax.random.split(rng, 1)[0])
    got = sample_construction.construction_arrays(make_sample_levels_fn(tmod, 1),
                                                  torch.from_numpy(x), eps=eps)
    L = len(levels)
    assert got["level"].tolist() == list(reversed(range(L)))
    accum = np.zeros_like(levels[0])
    for col, lvl in enumerate(reversed(range(L))):
        accum = accum + levels[lvl]
        sm = np.exp(accum) / np.exp(accum).sum(-1, keepdims=True)
        np.testing.assert_allclose(got["residual"][col].numpy(),
                                   levels[lvl][..., -1] - levels[lvl][..., 0], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got["softmax_fg"][col].numpy(), sm[..., -1], rtol=1e-4,
                                   atol=1e-4)
        margin = np.abs(accum[..., 1] - accum[..., 0])
        clear = margin > 1e-3  # masks may differ only at a near-tie
        np.testing.assert_array_equal(got["mask"][col].numpy()[clear], accum.argmax(-1)[clear])


def test_sample_maps_are_the_sampler_and_error_maps(pair):
    """compute_sample_maps: the sampler's probabilities of the image, their
    argmax and error_maps against its annotators' one-hot (JAX
    generate_samples.py:68-92)."""
    x, _, _, tmod = pair
    gts = torch.from_numpy(np.random.RandomState(2).randint(0, 2, (16, 16, 4)))
    sample_fn = make_sample_fn(tmod, 5)
    got = generate_samples.compute_sample_maps(sample_fn, torch.from_numpy(x), gts, 2,
                                               torch.Generator().manual_seed(3))
    probs = sample_fn(torch.from_numpy(x), torch.Generator().manual_seed(3))[:, 0]
    assert torch.equal(got["probs"], probs) and torch.equal(got["masks"], probs.argmax(-1))
    gt_oh = np.eye(2, dtype=np.float32)[gts.numpy().transpose(2, 0, 1)]
    for name, w in zip(("e_ss", "e_sy", "e_yy"), jax_error_maps(probs.numpy(), gt_oh)):
        np.testing.assert_allclose(got[name].numpy(), w, rtol=1e-5, atol=1e-5, err_msg=name)


def test_gif_frames_match_jax(tmp_path):
    """The port's frames are the JAX CLI's PIL frames (input in grey, the
    sample's contour in red, 4x nearest), and the written GIF holds them."""
    rng = np.random.RandomState(4)
    x = rng.randn(12, 10).astype(np.float32)
    masks = (rng.rand(5, 12, 10) > 0.5).astype(np.int64)
    got = makegif_samples.frames(x, masks)
    base = jax_gif._to_uint8(x)
    for s in range(5):
        frame = np.stack([base, base, base], -1)
        frame[jax_gif._contour(masks[s] > 0)] = [255, 64, 64]
        want = np.asarray(Image.fromarray(frame).resize((40, 48), Image.NEAREST))
        np.testing.assert_array_equal(got[s], want)
    path = str(tmp_path / "a.gif")
    makegif_samples.write_gif(path, got)
    with Image.open(path) as im:
        assert im.n_frames == 5 and im.size == (40, 48)
        im.seek(2)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), got[2])


@pytest.fixture(scope="module")
def log_dir(tmp_path_factory):
    """A log dir with best_* checkpoints: 3 steps, validating at steps 1 and 2."""
    root = tmp_path_factory.mktemp("figs")
    cfg = ExperimentConfig(experiment_name="figs", model_family="phiseg", latent_levels=2,
                           resolution_levels=4, n0=2, zdim0=2, image_size=(16, 16, 1),
                           compute_dtype="float32", norm="batch", batch_size=4,
                           data_identifier="synthetic", synth_n_train=8, synth_n_val=4,
                           synth_n_test=3, validation_frequency=1, validation_samples=3,
                           validation_elbo_samples=2, tensorboard_update_frequency=1,
                           do_image_summaries=False, do_histogram_summaries=False)
    path = str(root / "cfg.json")
    cfg.save(path)
    out = str(root / "log")
    train_main([path, "--num-iter", "3", "--log-dir", out, "--device", "cpu"])
    return out


def test_generate_samples_cli_writes_its_figures(log_dir):
    out = generate_samples.main([log_dir, "--samples", "4", "--indices", "0", "2",
                                 "--device", "cpu"])
    assert out == os.path.join(log_dir, "samples")
    assert sorted(os.listdir(out)) == ["samples_img0_best_ged.png", "samples_img2_best_ged.png"]
    with Image.open(os.path.join(out, "samples_img0_best_ged.png")) as im:
        assert im.format == "PNG" and im.size[0] > im.size[1] > 100


def test_sample_construction_cli_writes_its_figures(log_dir, tmp_path):
    out = sample_construction.main([log_dir, "--tag", "best_dice", "--out-dir",
                                    str(tmp_path), "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["construction_img0_best_dice.png",
                                       "construction_img1_best_dice.png"]
    with Image.open(os.path.join(out, "construction_img1_best_dice.png")) as im:
        assert im.format == "PNG" and min(im.size) > 100


def test_makegif_cli_writes_one_frame_per_sample(log_dir):
    out = makegif_samples.main([log_dir, "--samples", "3", "--indices", "1", "--device", "cpu"])
    with Image.open(os.path.join(out, "samples_img1_best_ged.gif")) as im:
        assert im.n_frames == 3 and im.size == (64, 64)


def _npz_files(tmp_path):
    rng = np.random.RandomState(6)
    files = {}
    for name, n_s in (("a", 10), ("b", 10), ("c", 1)):
        d_sy, d_ss, d_yy = (rng.uniform(0.2, 0.8, 12) for _ in range(3))
        f = str(tmp_path / f"ged_{name}.npz")
        np.savez(f, 2 * d_sy - d_ss - d_yy, d_sy=d_sy, d_ss=d_ss, d_yy=d_yy,
                 n_samples=np.asarray(n_s), n_annotators=np.asarray(4))
        files[f"ged_{name}"] = f
        f = str(tmp_path / f"dice_{name}.npz")
        np.savez(f, rng.uniform(0, 1, (12, 3)))
        files[f"dice_{name}"] = f
    f = str(tmp_path / "ncc_short.npz")
    np.savez(f, rng.uniform(0, 1, 9))
    files["ncc_short"] = f
    return files


@pytest.mark.parametrize("metric,names", [
    ("ged", ["ged_a", "ged_b", "ged_c"]),
    ("dice", ["dice_a", "dice_b"]),
    ("ncc", ["dice_a", "ncc_short"]),
])
def test_eval_plots_aggregate_matches_jax(metric, names, tmp_path, caplog):
    """Means, stds, unbiased GED^2 (skipped at N=1), paired t-tests and
    their skips on unequal n, on the same files; the log lines too."""
    files = _npz_files(tmp_path)
    paths = [files[n] for n in names]
    with caplog.at_level(logging.INFO):
        want = jax_eval_plots.aggregate(metric, paths, names)
        jax_log = [r.getMessage() for r in caplog.records]
        caplog.clear()
        got = eval_plots.aggregate(metric, paths, names)
        port_log = [r.getMessage() for r in caplog.records]
    assert repr(got) == repr(want)  # NaN where the estimator is undefined, in both
    assert port_log == jax_log


def test_eval_plots_boxplot(tmp_path):
    files = _npz_files(tmp_path)
    plot = str(tmp_path / "box.png")
    eval_plots.main(["ged", "--files", files["ged_a"], files["ged_b"], "--names", "a", "b",
                     "--plot", plot])
    with Image.open(plot) as im:
        assert im.format == "PNG"
