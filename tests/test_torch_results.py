"""The port's results tools (phiseg_tpu_torch/scripts/) against the JAX
package's scripts/ on the CPU.

results_table and pair_stats print the JAX scripts' text, character for
character, on the committed results/ npz, and read the npz files the port's
own eval CLIs write (each printed mean is its array's mean). dyy_report
reproduces the committed artifacts/dyy_report.txt (the JAX script's output;
that script is never run here, since it rewrites the file). ged_decomposition
gives the port's test_quantitative terms bit for bit and JAX's d_yy on the
committed phiseg_tpu log dir. scripts/sustained_report.py (not ported: it
imports neither jax nor the JAX package) reads the port's metrics.jsonl.
"""

import contextlib
import importlib.util
import io
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from phiseg_tpu_torch.cli.test_predictions import main as pred_main
from phiseg_tpu_torch.cli.test_quantitative import main as quant_main
from phiseg_tpu_torch.cli.test_quantitative import score_test_split
from phiseg_tpu_torch.cli.train import main as train_main
from phiseg_tpu_torch.data import get_dataset
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.trainer import Trainer
from phiseg_tpu_torch.scripts import dyy_report, ged_decomposition, pair_stats, results_table

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CKPT = os.path.join(ROOT, "tests", "data", "jax_checkpoint_small")
DYY_REPORT = os.path.join(ROOT, "artifacts", "dyy_report.txt")


def _jax_script(name):
    """The module of scripts/<name>.py (scripts/ is not a package)."""
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


# the RESULTS.md tables: the 48k comparison, the 24k bf one, the multiscale one
TABLES = [
    "lidc_bf/phiseg_7_5_bf lidc_bf/probunet_bf lidc2_bf/detunet_bf --suffix _48k",
    "lidc_bf/phiseg_7_5_bf lidc_bf/probunet_bf lidc_bf/phiseg_7_1_bf lidc2_bf/detunet_bf",
    "lidc_ms/phiseg_7_5_ms lidc_ms/probunet_ms lidc_ms/phiseg_7_1_ms lidc2_ms/detunet_ms",
]


@pytest.mark.parametrize("args", TABLES)
def test_results_table_prints_the_jax_scripts_text(args, monkeypatch):
    monkeypatch.setenv("PHISEG_LOG_ROOT", os.path.join(ROOT, "results"))
    want = _stdout(_jax_script("results_table").main, args.split())
    got = _stdout(results_table.main, args.split())
    assert got == want
    assert got.count("\n") >= 5 and "floor(" in got


PAIRS = [
    "results/lidc_bf/phiseg_7_5_bf results/lidc_bf/probunet_bf --suffix _48k",
    "results/lidc_bfxl/phiseg_7_5_bfxl results/lidc_bfxl/probunet_bfxl --suffix _48k",
    "results/lidc_ms/phiseg_7_5_ms results/lidc_ms/phiseg_7_1_ms",
]


@pytest.mark.parametrize("args", PAIRS)
def test_pair_stats_prints_the_jax_scripts_text(args):
    argv = [os.path.join(ROOT, a) if a.startswith("results/") else a for a in args.split()]
    want = _stdout(_jax_script("pair_stats").main, argv)
    got = _stdout(pair_stats.main, argv)
    assert got == want
    assert "biased GED^2" in got and "ratio" in got


def test_pair_stats_refuses_two_test_splits(tmp_path):
    for name, shift in (("a", 0.0), ("b", 0.1)):
        d = tmp_path / name
        d.mkdir()
        np.savez(d / "ged4_best_ged.npz", np.ones(3), d_sy=np.ones(3), d_ss=np.ones(3),
                 d_yy=np.full(3, 0.5 + shift), n_samples=np.asarray(4),
                 n_annotators=np.asarray(4))
    with pytest.raises(ValueError, match="d_yy differs"):
        pair_stats.main([str(tmp_path / "a"), str(tmp_path / "b"), "--samples", "4"])


# ---------------------------------------------------------------------------
# the port's own npz files
# ---------------------------------------------------------------------------

TINY = dict(latent_levels=2, resolution_levels=4, n0=2, zdim0=2, image_size=(16, 16, 1),
            compute_dtype="float32", norm="batch", batch_size=4, data_identifier="synthetic",
            synth_n_train=8, synth_n_val=4, synth_n_test=6, validation_frequency=1,
            validation_samples=3, validation_elbo_samples=2, tensorboard_update_frequency=1,
            do_image_summaries=False, do_histogram_summaries=False)


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """A tiny PHiSeg and a tiny ProbUNet trained 3 steps, each scored by the
    port's test_quantitative (6 samples) and test_predictions (4 samples)."""
    root = tmp_path_factory.mktemp("results")
    dirs = {}
    for name, family in (("phiseg_tiny", "phiseg"), ("probunet_tiny", "prob_unet")):
        cfg = ExperimentConfig(experiment_name=name, model_family=family, **TINY)
        path = str(root / f"{name}.json")
        cfg.save(path)
        log_dir = str(root / name)
        train_main([path, "--num-iter", "3", "--log-dir", log_dir, "--device", "cpu"])
        quant_main([log_dir, "--samples", "6", "--batch", "4", "--device", "cpu"])
        pred_main([log_dir, "--samples", "4", "--device", "cpu"])
        dirs[name] = log_dir
    return root, dirs


def _mean_of(path, key="arr_0", fg=False):
    with np.load(path) as z:
        a = np.asarray(z[key])
    return a[:, 1:].mean(axis=1).mean() if fg else a.mean()


def test_results_table_reads_the_ports_npz(evaluated, monkeypatch):
    root, dirs = evaluated
    monkeypatch.setenv("PHISEG_LOG_ROOT", str(root))
    out = _stdout(results_table.main, list(dirs) + ["--samples", "6"]).splitlines()
    assert out[0].startswith("| experiment (n=6) |")
    for name, d in dirs.items():
        row = next(r for r in out if r.startswith(f"| {name} |")).split(" | ")
        ged, ncc, dice = row[1], row[3], row[4].rstrip(" |")
        assert float(ged.split(" ± ")[0]) == pytest.approx(
            _mean_of(os.path.join(d, "ged6_best_ged.npz")), abs=5e-4)
        assert float(ncc.split(" ± ")[0]) == pytest.approx(
            _mean_of(os.path.join(d, "ncc6_best_ged.npz")), abs=5e-4)
        assert float(dice.split(" ± ")[0]) == pytest.approx(
            _mean_of(os.path.join(d, "dice_best_dice.npz"), fg=True), abs=5e-4)
        floor = next(r for r in out if r.startswith(f"floor({name})"))
        terms = [float(v) for v in re.findall(r"d_(?:sy|ss|yy) ([0-9.]+)", floor)]
        for key, v in zip(("d_sy", "d_ss", "d_yy"), terms):
            assert v == pytest.approx(_mean_of(os.path.join(d, "ged6_best_ged.npz"), key),
                                      abs=5e-5)


def test_pair_stats_reads_the_ports_npz(evaluated):
    _, dirs = evaluated
    out = _stdout(pair_stats.main, list(dirs.values()) + ["--samples", "6"])
    assert "paired over n=6 test images (phiseg_tiny vs probunet_tiny" in out
    for name, d in dirs.items():
        line = next(r for r in out.splitlines() if r.strip().startswith(f"{name}: d_sy"))
        for key in ("d_sy", "d_ss", "d_yy"):
            v = float(re.search(key + r" ([0-9.]+)", line).group(1))
            assert v == pytest.approx(_mean_of(os.path.join(d, "ged6_best_ged.npz"), key),
                                      abs=5e-5)
    means = re.search(r"biased GED\^2   : ([0-9.]+) vs ([0-9.]+)", out)
    for v, d in zip(means.groups(), dirs.values()):
        assert float(v) == pytest.approx(_mean_of(os.path.join(d, "ged6_best_ged.npz")),
                                         abs=5e-5)


# ---------------------------------------------------------------------------
# dyy_report, ged_decomposition, sustained_report
# ---------------------------------------------------------------------------


def test_dyy_report_reproduces_the_committed_report(tmp_path, capsys):
    with open(DYY_REPORT, "rb") as f:
        committed = f.read()
    text = dyy_report.main(["--device", "cpu", "--out", str(tmp_path / "dyy.txt")])
    assert text == committed.decode()
    assert capsys.readouterr().out.startswith(text)
    assert (tmp_path / "dyy.txt").read_bytes() == committed
    with open(DYY_REPORT, "rb") as f:
        assert f.read() == committed  # the committed file was not written


@pytest.fixture
def jax_log_dir(tmp_path):
    d = str(tmp_path / "jax_checkpoint_small")
    shutil.copytree(JAX_CKPT, d)
    return d


def test_ged_decomposition_gives_test_quantitatives_terms(jax_log_dir, capsys):
    """On the CPU the terms ged_decomposition draws (score_test_split's) are
    the ones test_quantitative writes, bit for bit, at the same --samples,
    --batch and --max-images (a short last batch included), and so are
    their means."""
    quant_main([jax_log_dir, "--samples", "5", "--batch", "3", "--max-images", "4",
                "--device", "cpu"])
    with np.load(os.path.join(jax_log_dir, "ged5_best_ged.npz")) as z:
        want = np.stack([z["d_sy"], z["d_ss"], z["d_yy"]], axis=1)
    step, _, _, _, terms = score_test_split(jax_log_dir, 5, "best_ged", 3, 4, None, "cpu")
    assert step == 3 and terms.shape == (4, 3)
    np.testing.assert_array_equal(terms, want)

    capsys.readouterr()
    (res,) = ged_decomposition.main([jax_log_dir, "--samples", "5", "--batch", "3",
                                     "--max-images", "4", "--device", "cpu"])
    np.testing.assert_array_equal([res["d_sy_fit"], res["d_ss_sample_diversity"],
                                   res["d_yy_annotator_diversity"]], want.mean(0))
    assert res["ged2"] == pytest.approx(2 * res["d_sy_fit"] - res["d_ss_sample_diversity"]
                                        - res["d_yy_annotator_diversity"], abs=1e-6)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["experiment", "GED^2", "d_sy", "d_ss", "d_yy", "ss/yy"]
    assert lines[1].split()[0] == "jax_checkpoint_small"
    assert float(lines[1].split()[4]) == pytest.approx(res["d_yy_annotator_diversity"],
                                                       abs=5e-5)


def test_ged_decomposition_d_yy_matches_the_jax_script(jax_log_dir):
    """d_yy depends on the annotations alone, so JAX's script and the port
    agree on it whatever their noise (the draws' terms do not)."""
    want = _jax_script("ged_decomposition").decompose(jax_log_dir, 4, 2, None, None)
    got = ged_decomposition.decompose(jax_log_dir, 4, 2, None, None, "cpu")
    assert got["n_images"] == want["n_images"] == 4 and got["step"] == want["step"] == 3
    assert got["d_yy_annotator_diversity"] == pytest.approx(
        want["d_yy_annotator_diversity"], abs=1e-6)
    assert got["d_yy_annotator_diversity"] > 0


def test_sustained_report_reads_the_trainers_metrics(tmp_path, monkeypatch):
    monkeypatch.setenv("PHISEG_LOG_ROOT", str(tmp_path))
    cfg = ExperimentConfig(experiment_name="sustained", model_family="phiseg",
                           **dict(TINY, validation_frequency=1000))
    trainer = Trainer(cfg, device="cpu")
    trainer.train(get_dataset(cfg, n_train=8, n_val=4, n_test=4), num_iter=6)
    sustained = _jax_script("sustained_report")
    r = sustained.report(trainer.log_dir)
    assert r["windows"] == 5 and r["steps"] == 5  # steps 0..5 logged, step 0 has no rate
    assert r["median_images_per_sec"] > 0
    monkeypatch.setattr(sys, "argv", ["sustained_report.py", trainer.log_dir])
    out = _stdout(lambda _: sustained.main(), None)
    assert out.startswith(f"{trainer.log_dir}: 5 windows over 5 steps |")
