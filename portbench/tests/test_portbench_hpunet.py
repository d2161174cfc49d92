"""The cell `hpunet-eval_b8` on the CPU: its tiny twin (R=5, n0=4, L=2,
32x32, float32) runs `correct` under the committed limits; at full width
the float8 control fails them while the program passes; and a broken
HPU-Net decode reads `correct` false: the prior's mean at its finest latent
level in place of the draw, or the finest encoder skip tiled from the
wrong image (its rows rolled by one). Also: the FLOPs the harness counts
over the configuration's reference equal those of the program's sampler."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.tests.tiny import PKG, ROOT, write_bench

torch.set_num_threads(1)
SEED = 2 ** 31 + 3
CELL = "hpunet-eval_b8"


def _limits():
    with open(f"{PKG}/limits/{CELL}.json") as f:
        return json.load(f)


def _fails(numbers, limits):
    return [k for k, v in limits.items() if not numbers[k] <= v]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny"))
    write_bench(d)
    return d


def _run(d):
    from portbench import run

    return run.run_cell(CELL, SEED, 0.3, False, device="cpu", root=d, pkg=d)


def test_an_unbroken_run_is_correct(tiny):
    result, checks = _run(tiny)
    assert result["correct"] and result["attempted"] > 0, checks
    assert [k for k, _, _ in checks] == ["prob_gap", "ged_gap", "sncc_gap"]


def test_the_control_fails_at_full_width(tmp_path):
    """2 samples of 2 images at the published widths, bfloat16 program."""
    from portbench.control import readings

    (tmp_path / "traffic").mkdir()
    with open(f"{PKG}/traffic/eval_b8_s100.json") as f:
        t = json.load(f)
    t.update(batch=2, samples=2, warmup_units=1, check_units=1)
    with open(tmp_path / "traffic" / "eval_b8_s100.json", "w") as f:
        json.dump(t, f)
    r = readings(CELL, SEED, 0.1, True, "cpu", ROOT, str(tmp_path))
    assert not _fails(r["program"], _limits())
    assert _fails(r["control"], _limits())


@pytest.mark.parametrize("fault", ["mean", "skip"])
def test_a_broken_decode_is_not_correct(fault, tiny, monkeypatch):
    from phiseg_tpu_torch.models.hpunet import HPUNetCore
    from phiseg_tpu_torch.models.segvae import SegVAE

    if fault == "mean":
        plain = HPUNetCore.decode

        def decode(self, enc, eps=None, *a, **k):
            if eps is not None:
                eps = [torch.zeros_like(eps[0]), *eps[1:]]
            return plain(self, enc, eps, *a, **k)

        monkeypatch.setattr(HPUNetCore, "decode", decode)
    else:
        plain = SegVAE.repeat_cache

        def repeat_cache(self, cache, n):
            tiled = plain(self, cache, n)
            return (torch.roll(tiled[0], 1, dims=0), *tiled[1:])

        monkeypatch.setattr(SegVAE, "repeat_cache", repeat_cache)
    result, checks = _run(tiny)
    assert not result["correct"], checks
    assert "prob_gap" in _fails({k: v for k, v, _ in checks}, _limits())


def test_the_sampler_flops_match_the_program():
    from phiseg_tpu_torch.engine.train import build_model, make_sample_fn
    from phiseg_tpu_torch.experiments import get_experiment

    from portbench import counts
    from portbench.cells import Bench
    from portbench.weights import make_weights

    cfg = get_experiment("hpunet_synth").replace(resolution_levels=5, latent_levels=2, n0=4,
                                                 image_size=(32, 32, 1), compute_dtype="float32")
    d = json.loads(cfg.to_json())
    ref = Bench(ROOT).reference({"reference": "hpunet"})
    model = build_model(cfg, "cpu")
    model.load_state_dict(make_weights(ref.param_spec(d), 0, "cpu", ref.init_std))
    with FlopCounterMode(display=False) as fc:
        make_sample_fn(model, 4)(torch.randn(2, 32, 32, 1), torch.Generator().manual_seed(0))
    assert counts.sample_flops(ref, d, 2, 4, metrics=False) == fc.get_total_flops() > 0
