"""The port's eval CLIs on the CPU: test_quantitative's npz contract of the
JAX package's CLI, read back by the port's eval_plots and by the JAX
package's numpy-only one alike; `--mesh 2` (two gloo ranks) giving `--mesh
1`'s results for test_quantitative and test_predictions; and every entry
point of the port (the figure CLIs included) refusing to fall back to the
CPU when the card it defaults to is missing."""

import json
import os

import numpy as np
import pytest
import torch

from phiseg_tpu_torch.cli import eval_plots, generate_samples, makegif_samples, sample_construction
from phiseg_tpu_torch.cli.test_predictions import main as pred_main
from phiseg_tpu_torch.cli.test_quantitative import main as quant_main
from phiseg_tpu_torch.cli.train import main as train_main
from phiseg_tpu_torch.data import get_dataset
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.loading import load_experiment
from phiseg_tpu_torch.engine.validation import make_quant_eval_fn

torch.set_num_threads(1)
# the keys of phiseg_tpu/cli/test_quantitative.py's files
GED_KEYS = ["arr_0", "d_ss", "d_sy", "d_yy", "n_annotators", "n_samples"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A log dir with best_* checkpoints: 3 steps, validating at steps 1 and 2."""
    root = tmp_path_factory.mktemp("quant")
    cfg = ExperimentConfig(experiment_name="quant", model_family="phiseg", latent_levels=2,
                           resolution_levels=4, n0=2, zdim0=2, image_size=(16, 16, 1),
                           compute_dtype="float32", norm="batch", batch_size=4,
                           data_identifier="synthetic", synth_n_train=8, synth_n_val=4,
                           synth_n_test=5, validation_frequency=1, validation_samples=3,
                           validation_elbo_samples=2, tensorboard_update_frequency=1,
                           do_image_summaries=False, do_histogram_summaries=False)
    path = str(root / "cfg.json")
    cfg.save(path)
    log_dir = str(root / "log")
    train_main([path, "--num-iter", "3", "--log-dir", log_dir, "--device", "cpu"])
    return path, log_dir


def test_quantitative_writes_the_npz_contract(trained):
    _, log_dir = trained
    ged, ncc = quant_main([log_dir, "--samples", "6", "--batch", "2", "--device", "cpu"])
    with np.load(os.path.join(log_dir, "ged6_best_ged.npz")) as z:
        assert sorted(z.keys()) == GED_KEYS
        assert z["arr_0"].shape == (5,) and np.isfinite(z["arr_0"]).all()
        for k in ("d_sy", "d_ss", "d_yy"):
            assert z[k].shape == (5,) and np.isfinite(z[k]).all()
        np.testing.assert_allclose(2 * z["d_sy"] - z["d_ss"] - z["d_yy"], z["arr_0"], rtol=1e-5,
                                   atol=1e-6)
        assert int(z["n_samples"]) == 6 and int(z["n_annotators"]) == 4
        np.testing.assert_array_equal(z["arr_0"], ged)
    with np.load(os.path.join(log_dir, "ncc6_best_ged.npz")) as z:
        assert list(z.keys()) == ["arr_0"]
        np.testing.assert_array_equal(z["arr_0"], ncc)
        assert np.isfinite(ncc).all() and ncc.shape == (5,)

    # the values: the quantitative function on the restored model, batch by
    # batch with the CLI's generator
    cfg, model, _, step = load_experiment(log_dir, "best_ged", device="cpu")
    assert step in (2, 3)  # the two validations saw state.step 2 and 3
    data = get_dataset(cfg)
    quant = make_quant_eval_fn(model, cfg, 6)
    g = torch.Generator().manual_seed(cfg.seed + 99)
    want = []
    for b0 in range(0, 5, 2):
        x = torch.from_numpy(data.test.images[b0:b0 + 2].astype(np.float32)[..., None])
        ann = torch.from_numpy(np.transpose(data.test.labels[b0:b0 + 2], (0, 3, 1, 2)))
        want.append(quant(x, ann, g)[0].numpy())
    np.testing.assert_array_equal(np.concatenate(want), ged)


def test_quantitative_options(trained):
    _, log_dir = trained
    ged, ncc = quant_main([log_dir, "--samples", "3", "--tag", "best_dice", "--max-images", "3",
                           "--synth-n-test", "9", "--out-suffix", "_x", "--device", "cpu"])
    assert ged.shape == ncc.shape == (3,)
    assert os.path.exists(os.path.join(log_dir, "ged3_best_dice_x.npz"))
    assert os.path.exists(os.path.join(log_dir, "ncc3_best_dice_x.npz"))
    ged, _ = quant_main([log_dir, "--samples", "3", "--synth-n-test", "9", "--device", "cpu"])
    assert ged.shape == (9,)


def _aggregate_ports_files(aggregate, log_dir, caplog):
    import logging

    f = os.path.join(log_dir, "ged4_best_ged.npz")
    caplog.clear()
    with caplog.at_level(logging.INFO):
        res = (aggregate("ged", [f, f], names=["a", "b"]),
               aggregate("ncc", [os.path.join(log_dir, "ncc4_best_ged.npz")] * 2,
                         names=["a", "b"]))
    return res, "\n".join(r.getMessage() for r in caplog.records)


def test_eval_plots_of_the_port_aggregates_its_files(trained, caplog):
    """The port's eval_plots aggregates the port's npz files, GED terms and
    finite-N/M corrections included."""
    _, log_dir = trained
    quant_main([log_dir, "--samples", "4", "--device", "cpu"])
    (ged, ncc), text = _aggregate_ports_files(eval_plots.aggregate, log_dir, caplog)
    assert "ged a:" in text and "GED terms a" in text and "ncc b:" in text
    assert "unbiased GED^2 a" in text and set(ged["unbiased_means"]) == {"a", "b"}
    assert ncc["means"]["a"] == ncc["means"]["b"]


def test_eval_plots_of_the_jax_package_reads_the_ports_files(trained, caplog):
    """phiseg_tpu.cli.eval_plots (numpy only) aggregates the port's npz
    files, GED terms and finite-N/M corrections included, to the port's
    eval_plots' results and log lines."""
    from phiseg_tpu.cli.eval_plots import aggregate

    _, log_dir = trained
    quant_main([log_dir, "--samples", "4", "--device", "cpu"])
    want, want_text = _aggregate_ports_files(aggregate, log_dir, caplog)
    got, got_text = _aggregate_ports_files(eval_plots.aggregate, log_dir, caplog)
    text = want_text
    assert "ged a:" in text and "GED terms a" in text and "ncc b:" in text
    assert repr(got) == repr(want)  # NaN t-tests of identical files, in both
    assert got_text == want_text


@pytest.mark.parametrize("cli", ["test_quantitative", "test_predictions"])
def test_eval_mesh_2_equals_mesh_1(trained, cli, tmp_path):
    """`--mesh 2` (two gloo ranks, each decoding half of the draws from the
    same noise) gives `--mesh 1`'s arrays and files, within rtol 1e-4 / atol
    1e-5 (JAX tests/test_cli.py:72-92): a rank decodes 3 x B rows instead of
    6 x B, which may sum the convolutions in another order."""
    import shutil

    _, log_dir = trained
    outs = {}
    for n in (1, 2):
        d = str(tmp_path / f"mesh{n}")
        shutil.copytree(log_dir, d)
        args = [d, "--samples", "6", "--batch", "2", "--device", "cpu", "--mesh", str(n)]
        main = quant_main if cli == "test_quantitative" else pred_main
        outs[n] = (d, main(args, timeout=120))
    (d1, r1), (d2, r2) = outs[1], outs[2]
    if cli == "test_quantitative":
        for a, b in zip(r2, r1):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        names = ["ged6_best_ged.npz", "ncc6_best_ged.npz"]
    else:
        np.testing.assert_allclose(r2, r1, rtol=1e-4, atol=1e-5)
        names = ["dice_best_dice.npz"]
    for name in names:
        with np.load(os.path.join(d1, name)) as z1, np.load(os.path.join(d2, name)) as z2:
            assert sorted(z1.keys()) == sorted(z2.keys())
            for k in z1:
                np.testing.assert_allclose(z2[k], z1[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("entry", ["Trainer", "load_experiment", "InferenceEngine.from_logdir",
                                   "cli.train", "cli.test_quantitative",
                                   "cli.test_predictions", "cli.test_quantitative --mesh",
                                   "cli.test_predictions --mesh", "cli.generate_samples",
                                   "cli.sample_construction", "cli.makegif_samples"])
def test_entry_points_take_the_card_and_raise_without_one(trained, entry):
    """Without a card every entry point of the new path raises unless it is
    asked for the CPU (on a machine with a card there is nothing to show)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    path, log_dir = trained
    cfg = ExperimentConfig.load(path)
    from phiseg_tpu_torch.engine.inference import InferenceEngine
    from phiseg_tpu_torch.engine.trainer import Trainer

    calls = {
        "Trainer": lambda: Trainer(cfg, log_dir=log_dir),
        "load_experiment": lambda: load_experiment(log_dir),
        "InferenceEngine.from_logdir": lambda: InferenceEngine.from_logdir(log_dir),
        "cli.train": lambda: train_main([path, "--num-iter", "4", "--log-dir", log_dir]),
        "cli.test_quantitative": lambda: quant_main([log_dir, "--samples", "2"]),
        "cli.test_predictions": lambda: pred_main([log_dir, "--samples", "2"]),
        "cli.test_quantitative --mesh": lambda: quant_main([log_dir, "--samples", "2",
                                                            "--mesh", "2"]),
        "cli.test_predictions --mesh": lambda: pred_main([log_dir, "--samples", "2",
                                                          "--mesh", "2"]),
        "cli.generate_samples": lambda: generate_samples.main([log_dir, "--samples", "2"]),
        "cli.sample_construction": lambda: sample_construction.main([log_dir]),
        "cli.makegif_samples": lambda: makegif_samples.main([log_dir, "--samples", "2"]),
    }
    before = sorted(os.listdir(log_dir))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        calls[entry]()
    assert sorted(os.listdir(log_dir)) == before  # nothing ran
    recs = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    assert max(r["step"] for r in recs) == 2
