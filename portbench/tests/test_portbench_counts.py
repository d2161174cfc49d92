"""The yardstick's counts: the FLOPs counted over the benchmark's reference
equal those counted over the program at a small size, and the fused
residual cross-entropy kernels' bytes at full width are those of the port's
kernel table (K1 / K2: 9.44 / 17.30 MB at L=5, 3.15 / 4.72 MB at L=1)."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import counts
from portbench.reference import model as R
from portbench.weights import make_weights

torch.set_num_threads(1)

SMALL = {"resolution_levels": 5, "n0": 4, "image_size": (32, 32, 1), "compute_dtype": "float32"}


def _cfg(name: str, **kw):
    from phiseg_tpu_torch.experiments import get_experiment

    cfg = get_experiment(name).replace(**SMALL, **kw)
    return cfg, json.loads(cfg.to_json())


def _model(cfg, d):
    from phiseg_tpu_torch.engine.train import build_model

    model = build_model(cfg, "cpu")
    model.load_state_dict(make_weights(R.param_spec(d), 0, "cpu", R.init_std))
    return model


@pytest.mark.parametrize("name,levels", [("phiseg_7_5_synth", 3), ("probunet_synth", 1)])
def test_train_step_flops_match_the_program(name, levels):
    from phiseg_tpu_torch.engine.objective import phiseg_objective
    from phiseg_tpu_torch.nn.losses import one_hot

    cfg, d = _cfg(name, latent_levels=levels)
    model = _model(cfg, d)
    x = torch.randn(3, 32, 32, 1)
    s_oh = one_hot(torch.randint(0, 2, (3, 32, 32)), 2)
    with FlopCounterMode(display=False) as fc:
        loss, _ = phiseg_objective(model(x, s_oh, generator=torch.Generator().manual_seed(0)), s_oh,
                                   cfg, model=model)
        loss.backward()
    assert counts.train_step_flops(R, d, 3) == fc.get_total_flops() > 0


@pytest.mark.parametrize("name,levels", [("phiseg_7_5_synth", 3), ("probunet_synth", 1)])
def test_sampler_flops_match_the_program(name, levels):
    from phiseg_tpu_torch.engine.train import make_sample_fn

    cfg, d = _cfg(name, latent_levels=levels)
    sample = make_sample_fn(_model(cfg, d), 4)
    with FlopCounterMode(display=False) as fc:
        sample(torch.randn(2, 32, 32, 1), torch.Generator().manual_seed(0))
    assert counts.sample_flops(R, d, 2, 4, metrics=False) == fc.get_total_flops() > 0


@pytest.mark.parametrize("name,k1_mb,k2_mb", [("phiseg_7_5.json", 9.44, 17.30),
                                              ("probunet.json", 3.15, 4.72)])
def test_frce_bytes_at_full_width(name, k1_mb, k2_mb):
    from portbench.tests.tiny import PKG

    with open(f"{PKG}/configs/{name}") as f:
        cfg = json.load(f)["experiment"]
    k1, k2 = counts.frce_bytes(cfg, cfg["batch_size"])
    assert (round(k1 / 1e6, 2), round(k2 / 1e6, 2)) == (k1_mb, k2_mb)


def test_full_width_flops_are_the_published_counts():
    """At full width: a PHiSeg train step at batch 12 is 900.47 GFLOP and a
    100-sample sampler call at batch 1 1913.52 GFLOP (counted on meta
    tensors, no compute)."""
    from portbench.tests.tiny import PKG

    with open(f"{PKG}/configs/phiseg_7_5.json") as f:
        cfg = json.load(f)["experiment"]
    assert round(counts.train_step_flops(R, cfg, 12) / 1e9, 2) == 900.47
    assert round(counts.sample_flops(R, cfg, 1, 100, metrics=False) / 1e9, 2) == 1913.52
