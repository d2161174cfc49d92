"""The port's entry points on the CPU: `python -m phiseg_tpu_torch <name>`
forwards each reference script name and each results tool to its main;
graft_entry.entry's loss matches the body of __graft_entry__.py's fn on
the same weights and posterior noise; dryrun_multichip runs two gloo ranks;
profile_step traces a tiny train step and sampler; and every new entry
point that touches a device refuses to fall back to the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phiseg_tpu_torch.__main__ as dispatch
from phiseg_tpu.engine import build_model as jax_build_model
from phiseg_tpu.engine import phiseg_objective as jax_objective
from phiseg_tpu.experiments import get_experiment as jax_get_experiment
from phiseg_tpu.nn.losses import one_hot as jax_one_hot
from phiseg_tpu_torch import graft_entry
from phiseg_tpu_torch.convert import flax_to_state_dict
from phiseg_tpu_torch.experiments import get_experiment
from phiseg_tpu_torch.scripts import dyy_report, ged_decomposition, profile_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference scripts' names and the module each forwards to
REFERENCE = {
    "phiseg_train": "phiseg_tpu_torch.cli.train",
    "phiseg_test_quantitative": "phiseg_tpu_torch.cli.test_quantitative",
    "phiseg_test_predictions": "phiseg_tpu_torch.cli.test_predictions",
    "phiseg_generate_samples": "phiseg_tpu_torch.cli.generate_samples",
    "phiseg_sample_construction": "phiseg_tpu_torch.cli.sample_construction",
    "phiseg_makegif_samples": "phiseg_tpu_torch.cli.makegif_samples",
    "eval_ged_plot": "phiseg_tpu_torch.cli.eval_plots",
    "eval_ncc_plot": "phiseg_tpu_torch.cli.eval_plots",
    "eval_dice_plot": "phiseg_tpu_torch.cli.eval_plots",
    "results_table": "phiseg_tpu_torch.scripts.results_table",
    "pair_stats": "phiseg_tpu_torch.scripts.pair_stats",
    "ged_decomposition": "phiseg_tpu_torch.scripts.ged_decomposition",
    "dyy_report": "phiseg_tpu_torch.scripts.dyy_report",
    "profile_step": "phiseg_tpu_torch.scripts.profile_step",
}


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_each_name_forwards_its_argv(name, monkeypatch):
    import importlib

    module = importlib.import_module(REFERENCE[name])
    calls = []
    monkeypatch.setattr(module, "main", lambda argv: calls.append(argv) or "ran")
    assert dispatch.main([name, "a", "--b", "3"]) == "ran"
    kind = name.split("_")[1] if name.startswith("eval_") else None
    assert calls == [([kind] if kind else []) + ["a", "--b", "3"]]


def test_unknown_name_exits_nonzero_with_the_list(capsys):
    with pytest.raises(SystemExit) as e:
        dispatch.main(["phiseg_train.py", "phiseg_7_5"])
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert "unknown command 'phiseg_train.py'" in err
    assert all(name in err for name in REFERENCE)
    with pytest.raises(SystemExit) as e:
        dispatch.main([])
    assert e.value.code != 0


def test_help_lists_every_name(capsys):
    dispatch.main(["--help"])
    out = capsys.readouterr().out
    assert all(f"  {name} " in out for name in REFERENCE)
    assert sorted(dispatch.COMMANDS) == sorted(REFERENCE)


# ---------------------------------------------------------------------------
# graft_entry
# ---------------------------------------------------------------------------

# f32 through ~40 convolutions and batch norms and sums over 64x64 pixels:
# the relative gap is the round-off of the two libraries' reduction orders
# (measured 3.4e-7 on a loss of 1.45e4)
ENTRY_RTOL = 1e-5
REDUCED = dict(image_size=(64, 64, 1), n0=4, compute_dtype="float32")


def _jax_variables(model, cfg, x, s_oh, rng, key):
    """Flax's variable tree without compiling its init, filled from numpy:
    he-scaled kernels, small biases, BN scales and running statistics."""
    shapes = jax.eval_shape(lambda k, a, s: model.init({"params": k}, a, s, k, train=True),
                            key, jnp.asarray(x), jnp.asarray(s_oh))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            return (rng.randn(*leaf.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_entry_matches_the_jax_entry_fn():
    """The port's fn against __graft_entry__.py's fn body (:31-35) at the
    flagship's topology (R=7, L=5) cut to 64x64 and n0=4, f32: the same
    weights (convert.py) and the JAX forward's posterior noise injected."""
    cfg_j = jax_get_experiment("phiseg_7_5_synth").replace(**REDUCED)
    model_j = jax_build_model(cfg_j)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 64, 64, 1).astype(np.float32)
    s = (rng.rand(2, 64, 64) > 0.6).astype(np.int32)
    key = jax.random.PRNGKey(0)
    s_oh_j = jax_one_hot(jnp.asarray(s), cfg_j.nlabels)
    variables = _jax_variables(model_j, cfg_j, x, s_oh_j, rng, key)

    @jax.jit
    def jax_fn(variables, x, s, rng):  # __graft_entry__.py:31-35, plus the noise
        s_oh = jax_one_hot(s, cfg_j.nlabels)
        outputs = model_j.apply(variables, x, s_oh, rng, train=False)
        loss, _ = jax_objective(outputs, s_oh, cfg_j, params=variables["params"])
        return loss, outputs.z, outputs.q_mu, outputs.q_sigma

    want, z, mu, sigma = jax_fn(variables, jnp.asarray(x), jnp.asarray(s), key)
    eps = [torch.from_numpy((np.asarray(a) - np.asarray(m)) / np.asarray(sd))
           for a, m, sd in zip(z, mu, sigma)]

    fn, (model, x0, s0, _) = graft_entry.entry("cpu", get_experiment("phiseg_7_5_synth")
                                               .replace(**REDUCED))
    assert x0.shape == (2, 64, 64, 1) and s0.shape == (2, 64, 64) and not x0.any()
    model.load_state_dict(flax_to_state_dict(variables, model))
    with torch.no_grad():
        got = fn(model, torch.from_numpy(x), torch.from_numpy(s), eps=eps)
    assert got.shape == () and np.isfinite(float(want))
    assert float(got) == pytest.approx(float(want), rel=ENTRY_RTOL)


def test_entry_full_width_on_the_cpu():
    """The default: phiseg_7_5_synth at full width (128x128, n0=32, R=7, L=5)
    on its example args, a finite scalar; the model left in eval mode."""
    fn, args = graft_entry.entry("cpu")
    model, x, s, generator = args
    assert x.shape == (2, 128, 128, 1) and s.shape == (2, 128, 128)
    assert model.posterior.tower.level0_conv0.conv.weight.shape[0] == 32
    with torch.no_grad():
        loss = fn(*args)
    assert loss.shape == () and torch.isfinite(loss)
    assert not model.training


def test_dryrun_multichip_two_gloo_ranks(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks' torch threads
    outs = graft_entry.dryrun_multichip(2, device="cpu")
    assert len(outs) == 2
    (l0, _), (l1, _) = outs
    assert l0 == l1 and len(l0) == 3  # the losses are global means
    assert all(np.isfinite(l0)) and l0[-1] < l0[0]


def test_profile_step_traces_a_tiny_train_step_and_sampler(tmp_path):
    cfg = get_experiment("phiseg_7_5_synth").replace(
        latent_levels=3, resolution_levels=5, n0=4, image_size=(32, 32, 1), batch_size=2,
        compute_dtype="float32")
    for which, batch, units in (("train", 1, profile_step.TRACED_CALLS),
                                ("sampler", 2, 2 * profile_step.TRACED_CALLS)):
        out = profile_step.capture(which, str(tmp_path / which), "cpu", batch, cfg)
        assert out["units"] == units and os.path.exists(out["trace"])
        assert os.path.dirname(out["trace"]) == str(tmp_path / which)
        assert out["window_us"] > 0 and out["peak_gib"] is None
        assert out["device_us"] == 0  # host ops only
        assert out["named"] == {k: 0 for k in profile_step.KERNEL_NAMES} == {"K1": 0, "K2": 0,
                                                                               "U2F": 0, "U2B": 0}
        assert out["launches"]["upsample2x_fwd"] == out["launches"]["upsample2x_bwd"] == 0
        spans = {name: (calls, dev) for name, calls, _, dev in out["spans"]}
        per_call = (["train_step", "train_step.augment", "train_step.forward",
                     "train_step.backward", "train_step.optimizer"] if which == "train" else
                    ["sample.encode", "sample.decode", "sample.decode.tile", "sample.softmax"])
        assert spans == {name: (profile_step.TRACED_CALLS, None) for name in per_call}
        profile_step.report(out)


def test_summarize_trace_counts_device_time_by_name(tmp_path):
    """The trace reader behind profile_step and chip_smoke: overlapping
    device events count once in the busy time, each op's time and calls
    are summed by name, host ops are in the window but not the device."""
    from phiseg_tpu_torch.utils.profiling import launches_named, summarize_trace

    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 100},
              {"ph": "X", "cat": "kernel", "name": "frce_fwd_kernel<float>", "ts": 10, "dur": 5},
              {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 12, "dur": 11},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 40, "dur": 4},
              {"ph": "X", "cat": "kernel", "name": "frce_fwd_kernel<float>", "ts": 60, "dur": 5},
              {"ph": "i", "cat": "kernel", "name": "marker", "ts": 200}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = summarize_trace(str(path))
    assert out["window_us"] == 100 and out["busy_us"] == 13 + 4 + 5
    assert out["device_us"] == 25 and out["kernels"] == 3
    assert out["ops"] == [("gemm", 11, 1), ("frce_fwd_kernel<float>", 10, 2),
                          ("Memcpy HtoD", 4, 1)]
    assert launches_named(out, "frce_fwd_kernel") == 2
    assert launches_named(out, "frce_bwd_kernel") == 0


@pytest.mark.parametrize("entry", ["entry", "dryrun_multichip", "ged_decomposition",
                                   "dyy_report", "profile_step train",
                                   "profile_step sampler"])
def test_entry_points_raise_without_a_card(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    log_dir = os.path.join(ROOT, "tests", "data", "jax_checkpoint_small")
    calls = {
        "entry": lambda: graft_entry.entry(),
        "dryrun_multichip": lambda: graft_entry.dryrun_multichip(2),
        "ged_decomposition": lambda: ged_decomposition.main([log_dir, "--samples", "2"]),
        "dyy_report": lambda: dyy_report.main([]),
        "profile_step train": lambda: profile_step.main(["train", str(tmp_path)]),
        "profile_step sampler": lambda: profile_step.main(["sampler", str(tmp_path)]),
    }
    with pytest.raises(RuntimeError, match="no CUDA card"):
        calls[entry]()
    assert os.listdir(tmp_path) == []
