"""The cell `ssn-eval_b8` on the CPU: its tiny twin (R=5, n0=4, rank 3,
32x32, float32) runs `correct` under the committed limits; a broken SSN
draw reads `correct` false by prob_gap: the factor W dropped, sqrt(D)
dropped, D in place of sqrt(D), and the rank-major factor read class-major.
Also: the two plain references of SSN (the repository's and this
benchmark's) give the same probabilities, the FLOPs the harness counts over
the configuration's reference equal those of the program's sampler, and the
two readers of SSN's spans."""

import json
import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.tests.tiny import PKG, ROOT, write_bench

torch.set_num_threads(1)
SEED = 2 ** 31 + 21
CELL = "ssn-eval_b8"


def _limits():
    with open(f"{PKG}/limits/{CELL}.json") as f:
        return json.load(f)


def _fails(numbers, limits):
    return [k for k, v in limits.items() if not numbers[k] <= v]


# The tiny twin's features h are ~1e-3 rms on the synthetic images (R=5,
# n0=4; the full model's ~2e-2): its heads' kernels are drawn at this scale
# of He normal, so that mu, W and log D spread by a few tenths, as the full
# model's do at the reference's HEAD_SCALE, and every part of the draw shows.
TINY_HEAD_SCALE = 250.0


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tiny"))
    write_bench(d)
    return d


@pytest.fixture
def heads(monkeypatch):
    from portbench.cells import Bench

    monkeypatch.setattr(Bench(ROOT).reference({"reference": "ssn"}), "HEAD_SCALE",
                        TINY_HEAD_SCALE)


def _run(d):
    from portbench import run

    return run.run_cell(CELL, SEED, 0.3, False, device="cpu", root=d, pkg=d)


def test_an_unbroken_run_is_correct(tiny, heads):
    result, checks = _run(tiny)
    assert result["correct"] and result["attempted"] > 0, checks
    assert [k for k, _, _ in checks] == ["prob_gap", "ged_gap", "sncc_gap"]


def _class_major(factor, classes):
    """The factor's columns as a class-major reading of the heads' C R
    channels (channel c R + r) would give them."""
    b, n, rank = factor.shape
    raw = factor.transpose(1, 2).reshape(b, rank * classes, n // classes)  # channel r C + c
    return raw.reshape(b, classes, rank, -1).permute(0, 1, 3, 2).reshape(b, n, rank)


FAULTS = {
    "no_factor": lambda m, f, d: (m, torch.zeros_like(f), d),
    "no_diag": lambda m, f, d: (m, f, torch.zeros_like(d)),
    "diag_not_its_root": lambda m, f, d: (m, f, d.square()),
    "class_major_factor": lambda m, f, d: (m, _class_major(f, 2), d),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_draw_is_not_correct(fault, tiny, heads, monkeypatch):
    from phiseg_tpu_torch.models.ssn import SSN

    plain = SSN.decode_sample

    def decode_sample(self, cache, *a, **k):
        return plain(self, FAULTS[fault](*cache), *a, **k)

    monkeypatch.setattr(SSN, "decode_sample", decode_sample)
    result, checks = _run(tiny)
    assert not result["correct"], checks
    assert "prob_gap" in _fails({k: v for k, v, _ in checks}, _limits())


def _tiny_cfg():
    from phiseg_tpu_torch.experiments import get_experiment

    return get_experiment("ssn_synth").replace(resolution_levels=5, n0=4, zdim0=3,
                                               image_size=(32, 32, 1), compute_dtype="float32")


def _weights(ref, d, seed=0):
    from portbench.weights import make_weights

    return make_weights(ref.param_spec(d), seed, "cpu", ref.init_std)


def test_the_two_references_agree():
    from portbench.cells import Bench
    from reference_torch import ssn as RT

    d = json.loads(_tiny_cfg().to_json())
    ref = Bench(ROOT).reference({"reference": "ssn"})
    params = _weights(ref, d, 1)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((2, 32, 32, 1), generator=g)
    eps = [torch.randn((4, *shape), generator=g) for shape in ref.latent_shapes(d, 2)]
    want = RT.sample_probs(d, params, x, eps)
    got = ref.sample_probs(d, params, x, eps)
    assert got.shape == want.shape == (4, 2, 32, 32, 2)
    assert float((got - want).abs().max()) <= 1e-6  # float32, the same sums in one order
    assert float(want[..., 1].std()) > 0.05  # not flat at the harness's head scale


def test_the_sampler_flops_match_the_program():
    from phiseg_tpu_torch.engine.train import build_model, make_sample_fn

    from portbench import counts
    from portbench.cells import Bench

    cfg = _tiny_cfg()
    d = json.loads(cfg.to_json())
    ref = Bench(ROOT).reference({"reference": "ssn"})
    model = build_model(cfg, "cpu")
    model.load_state_dict(_weights(ref, d))
    with FlopCounterMode(display=False) as fc:
        make_sample_fn(model, 4)(torch.randn(2, 32, 32, 1), torch.Generator().manual_seed(0))
    assert counts.sample_flops(ref, d, 2, 4, metrics=False) == fc.get_total_flops() > 0


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _rec(name, device_ms):
    return types.SimpleNamespace(name=name, events=(_Event(0.0), _Event(device_ms)))


READERS = {"decode_lowrank_device_ms.ssn_eval": "sample.decode.lowrank",
           "sample_encode_device_ms.ssn_eval": "sample.encode"}


@pytest.mark.parametrize("name", list(READERS))
@pytest.mark.parametrize("case", ["log", "cpu", "untraced", "no_span", "no_log"])
def test_the_readers_of_ssn_s_spans(name, case, monkeypatch):
    """Device ms an image: the mean of the spans' event intervals over the
    batch; nothing on the CPU, without a trace, without the span (the
    parent commit) or without the log."""
    from phiseg_tpu_torch.utils import profiling

    from portbench.cells import Bench

    span = READERS[name] if case != "no_span" else "sample.decode.tile"
    log = [_rec(span, 4.0), _rec(span, 6.0), _rec("eval.metrics", 100.0)]
    monkeypatch.setattr(profiling, "SPANS", types.SimpleNamespace(records=lambda: list(log)))
    if case == "no_log":
        monkeypatch.delattr(profiling, "SPANS")
    ctx = types.SimpleNamespace(device_name="cpu" if case == "cpu" else "NVIDIA H100 80GB HBM3",
                                trace=None if case == "untraced" else {}, batch=8)
    got = Bench(ROOT).reader(name)(ctx)
    assert got == (pytest.approx(5.0 / 8, rel=1e-12) if case == "log" else None)
