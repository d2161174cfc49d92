"""The port's msgpack decoder and phiseg_tpu checkpoints in the port, on the CPU.

  * engine/msgpack_reader.unpackb against msgpack.unpackb on generated
    objects, and msgpack_restore against flax.serialization.msgpack_restore
    on TrainState bytes, extension types and chunked leaves;
  * convert.flax_train_state_to_port: every optimiser's state placed;
  * the committed fixture tests/data/jax_checkpoint_small (written by
    scripts/make_jax_checkpoint_fixture.py): the JAX package restores it and
    reproduces its expected.npz, and the port loads it through
    load_experiment and matches expected.npz given the stored noise;
  * a log dir that phiseg_tpu's Trainer wrote, loaded by the port: Adam's
    state equal to optax's, sample probabilities and one further step
    against the JAX package's.

Tolerances: 1e-4 (rtol and atol) between the packages, about twenty f32
convolutions in a chain summed in another order (tests/test_torch_sampler.py);
1e-5 for the JAX package against its own earlier run on the CPU.
"""

import glob
import os
import shutil

import flax.serialization as fser
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from phiseg_tpu.engine.config import ExperimentConfig as JaxConfig
from phiseg_tpu.engine.train import TrainState as JaxTrainState
from phiseg_tpu.engine.train import build_model as jax_build_model
from phiseg_tpu.engine.train import create_train_state as jax_create_train_state
from phiseg_tpu.engine.train import make_optimizer as jax_make_optimizer
from phiseg_tpu.engine.train import make_sample_fn as jax_make_sample_fn
from phiseg_tpu.engine.train import make_train_step as jax_make_train_step
from phiseg_tpu_torch.convert import flax_to_state_dict, flax_train_state_to_port
from phiseg_tpu_torch.engine.checkpoint import load_tag
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.loading import load_experiment
from phiseg_tpu_torch.engine.msgpack_reader import msgpack_restore, unpackb
from phiseg_tpu_torch.engine.train import create_train_state, make_eval_loss_fn, make_sample_fn, \
    make_train_step

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "jax_checkpoint_small")
TOL = dict(rtol=1e-4, atol=1e-4)
JAX_SELF_TOL = dict(rtol=1e-5, atol=1e-6)


def _tree_equal(got, want, path="."):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


# -- the decoder ------------------------------------------------------------------


def _ext(code, data):
    return ("ext", code, data)


_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
            | st.floats(allow_nan=False) | st.text() | st.binary()
            | st.builds(msgpack.ExtType, st.integers(0, 127), st.binary()))
_objects = st.recursive(
    _scalars,
    lambda inner: st.lists(inner) | st.dictionaries(st.text() | st.integers(-5, 300), inner),
    max_leaves=40)


@settings(max_examples=300, deadline=None, database=None)
@given(obj=_objects, single_float=st.booleans())
def test_unpackb_matches_msgpack(obj, single_float):
    data = msgpack.packb(obj, use_bin_type=True, use_single_float=single_float)
    want = msgpack.unpackb(data, raw=False, strict_map_key=False, ext_hook=_ext)
    assert unpackb(data, ext_hook=_ext) == want


@pytest.mark.parametrize("n", [0, 15, 16, 2 ** 16])
def test_unpackb_lengths_of_every_width(n):
    """fix / 16-bit / 32-bit lengths of str, bin, array and map."""
    obj = {"s": "x" * n, "b": b"y" * n, "a": list(range(min(n, 70000))),
           "m": {str(i): i for i in range(min(n, 70000))}}
    data = msgpack.packb(obj, use_bin_type=True)
    assert unpackb(data) == msgpack.unpackb(data, raw=False)


@pytest.mark.parametrize("data,match", [
    (b"\xc1", "not valid"),
    (msgpack.packb([1, 2, 3])[:-1], "ends at byte"),
    (msgpack.packb(1) + b"\x00", "after the msgpack object"),
    (msgpack.packb(msgpack.ExtType(5, b"abc")), "no ext_hook"),
])
def test_unpackb_raises_on_bad_data(data, match):
    with pytest.raises(ValueError, match=match):
        unpackb(data)


def test_msgpack_restore_raises_on_a_foreign_ext_type():
    with pytest.raises(ValueError, match="not one that flax writes"):
        msgpack_restore(msgpack.packb({"a": msgpack.ExtType(9, b"")}))


def _tiny_jax_state(optimizer="adam"):
    """A JAX TrainState of a tiny PHiSeg at step 0: the variables' shapes
    from jax.eval_shape (no compile), filled from numpy."""
    cfg = JaxConfig(model_family="phiseg", latent_levels=2, resolution_levels=3, n0=2,
                    image_size=(8, 8, 1), compute_dtype="float32", norm="batch",
                    optimizer=optimizer)
    model = jax_build_model(cfg)
    tx = jax_make_optimizer(cfg)
    x, s_oh = jnp.zeros((2, 8, 8, 1)), jnp.zeros((2, 8, 8, 2))
    shapes = jax.eval_shape(lambda k: model.init({"params": k}, x, s_oh, k, train=True),
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    v = jax.tree_util.tree_map(lambda a: rng.rand(*a.shape).astype(np.float32), shapes)
    state = JaxTrainState(step=np.zeros((), np.int32), params=v["params"],
                          batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))
    return cfg, model, state


def test_msgpack_restore_matches_flax_on_a_train_state():
    _, _, state = _tiny_jax_state()
    data = fser.to_bytes(state)
    _tree_equal(msgpack_restore(data), fser.msgpack_restore(data))


def test_msgpack_restore_extension_types():
    """ndarrays of several dtypes (bfloat16 widens to f32 exactly), numpy
    scalars (ext 3) and complex numbers (ext 2)."""
    tree = {"f16": np.arange(6, dtype=np.float16).reshape(2, 3),
            "i8": np.array([-3, 4], np.int8), "u64": np.array([2 ** 63], np.uint64),
            "b": np.array([True, False]), "scalar": np.float32(2.5), "int": np.int32(-7),
            "c": complex(1.5, -2.0), "empty": np.zeros((0, 3), np.float32)}
    data = fser.msgpack_serialize(dict(tree))
    _tree_equal(msgpack_restore(data), fser.msgpack_restore(data))
    bf = jnp.array([1.0, -2.5, 3.0e-3, 1e30], jnp.bfloat16)
    got = msgpack_restore(fser.msgpack_serialize({"bf": bf}))["bf"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(bf.astype(jnp.float32)))


def test_msgpack_restore_joins_chunked_leaves(monkeypatch):
    """flax splits a leaf over MAX_CHUNK_SIZE bytes into chunks (made small
    here so a small array is split)."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(100, dtype=np.float32).reshape(4, 25), "nested": {
        "v": np.arange(40, dtype=np.float64)}, "small": np.ones(3, np.float32)}
    data = fser.msgpack_serialize(dict(tree))
    raw = msgpack.unpackb(data, raw=False)
    assert raw["w"]["__msgpack_chunked_array__"] and len(raw["w"]["chunks"]) == 7
    got = msgpack_restore(data)
    _tree_equal(got, fser.msgpack_restore(data))
    _tree_equal(got, tree)


# -- the optimiser state ------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["adam", "momentum", "sgd"])
def test_train_state_to_port_places_each_optimiser_state(optimizer):
    """Random moments / trace in optax's structure land on the matching
    parameter, transposed as it is; the step and Adam's count carry over."""
    jcfg, _, jstate = _tiny_jax_state(optimizer)
    rng = np.random.RandomState(0)
    rand = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: rng.randn(*a.shape).astype(np.float32), t)
    adam_or_trace, sched = jstate.opt_state
    if optimizer == "adam":
        adam_or_trace = adam_or_trace._replace(count=jnp.array(5, jnp.int32),
                                               mu=rand(adam_or_trace.mu),
                                               nu=jax.tree_util.tree_map(np.abs, rand(adam_or_trace.nu)))
    elif optimizer == "momentum":
        adam_or_trace = adam_or_trace._replace(trace=rand(adam_or_trace.trace))
    jstate = jstate.replace(step=jnp.array(5, jnp.int32),
                            opt_state=(adam_or_trace, sched._replace(count=jnp.array(5, jnp.int32))))
    tree = msgpack_restore(fser.to_bytes(jstate))

    cfg = ExperimentConfig.from_json(jcfg.to_json())
    state = create_train_state(cfg, device="cpu", seed=1)
    flax_train_state_to_port(tree, state)
    assert state.step == 5
    model, opt = state.model, state.optimizer
    bs = tree["batch_stats"]

    def converted(t):
        return flax_to_state_dict({"params": t, "batch_stats": bs}, model)

    params = dict(model.named_parameters())
    for name, want in converted(tree["params"]).items():
        assert torch.equal(model.state_dict()[name], want), name
    if optimizer == "adam":
        mu, nu = converted(tree["opt_state"]["0"]["mu"]), converted(tree["opt_state"]["0"]["nu"])
        for name, p in params.items():
            st_ = opt.state[p]
            assert float(st_["step"]) == 5.0
            assert torch.equal(st_["exp_avg"], mu[name]) and torch.equal(st_["exp_avg_sq"], nu[name])
    elif optimizer == "momentum":
        trace = converted(tree["opt_state"]["0"]["trace"])
        for name, p in params.items():
            assert torch.equal(opt.state[p]["momentum_buffer"], trace[name]), name
    else:
        assert not opt.state


def test_train_state_to_port_raises_on_what_it_cannot_place():
    jcfg, _, jstate = _tiny_jax_state()
    cfg = ExperimentConfig.from_json(jcfg.to_json())
    state = create_train_state(cfg, device="cpu")
    tree = msgpack_restore(fser.to_bytes(jstate))
    tree["opt_state"]["0"]["extra"] = np.zeros(1)
    with pytest.raises(KeyError, match="extra"):
        flax_train_state_to_port(tree, state)
    tree = msgpack_restore(fser.to_bytes(jstate))
    tree["opt_state"]["1"]["count"] = np.array(4, np.int32)
    with pytest.raises(ValueError, match="not the step"):
        flax_train_state_to_port(tree, state)
    tree = msgpack_restore(fser.to_bytes(jstate))
    mu = tree["opt_state"]["0"]["mu"]
    mu[next(iter(mu))]["stray"] = {"kernel": np.zeros((1, 1, 1, 1), np.float32)}
    with pytest.raises(KeyError):
        flax_train_state_to_port(tree, state)


# -- the committed fixture ------------------------------------------------------------


def _expected():
    with np.load(os.path.join(FIXTURE, "expected.npz")) as f:
        return dict(f)


def _levels(exp, prefix):
    n = len([k for k in exp if k.startswith(prefix)])
    return [torch.from_numpy(exp[f"{prefix}{i}"]) for i in range(n)]


def test_fixture_is_small_and_holds_one_best_ged_checkpoint():
    files = sorted(os.listdir(FIXTURE))
    assert len(glob.glob(os.path.join(FIXTURE, "model_best_ged.ckpt-*.msgpack"))) == 1
    assert "config.json" in files and "expected.npz" in files and len(files) == 3
    assert sum(os.path.getsize(os.path.join(FIXTURE, f)) for f in files) < 2 ** 20


def test_jax_package_reproduces_the_fixture():
    """The fixture cannot drift from what phiseg_tpu writes and computes."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_fixture", os.path.join(ROOT, "scripts", "make_jax_checkpoint_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg, model, state, step = mod.restore(FIXTURE)
    assert int(state.step) == step
    want, got = _expected(), mod.expected_arrays(cfg, model, state)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **JAX_SELF_TOL)


def test_port_loads_the_fixture_and_matches_jax(tmp_path):
    log_dir = str(tmp_path / "log")
    shutil.copytree(FIXTURE, log_dir)
    exp = _expected()
    cfg, model, state, step = load_experiment(log_dir, "best_ged", device="cpu")
    assert step == state.step and cfg.experiment_name == "jax_checkpoint_small"
    x = torch.from_numpy(exp["x"])
    probs = make_sample_fn(model, exp["probs"].shape[0])(x, eps=_levels(exp, "eps_prior_"))
    np.testing.assert_allclose(probs.numpy(), exp["probs"], **TOL)
    losses = make_eval_loss_fn(model, cfg)(x, torch.from_numpy(exp["s"]),
                                           eps=_levels(exp, "eps_post_"))
    want = {k[len("loss_"):]: v for k, v in exp.items() if k.startswith("loss_")}
    assert sorted(losses) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(losses[k]), v, err_msg=k, **TOL)


def test_load_tag_refuses_one_step_in_both_formats(tmp_path):
    from phiseg_tpu_torch.engine.checkpoint import CheckpointManager

    log_dir = str(tmp_path / "log")
    shutil.copytree(FIXTURE, log_dir)
    cfg = ExperimentConfig.load(os.path.join(log_dir, "config.json"))
    state = create_train_state(cfg, device="cpu")
    _, step = load_tag(state, log_dir, "best_ged")
    CheckpointManager(log_dir).save(state, "best_ged")  # .pt at the same step
    with pytest.raises(ValueError, match="both"):
        load_tag(state, log_dir, "best_ged")
    CheckpointManager(log_dir).save(state, "best_ged", step=step + 1)  # a newer .pt wins
    assert load_tag(state, log_dir, "best_ged")[1] == step + 1
    with pytest.raises(FileNotFoundError):
        load_tag(state, log_dir, "best_ncc")


# -- a log dir that phiseg_tpu's Trainer wrote --------------------------------------


JAX_RUN = dict(experiment_name="jax_run", model_family="phiseg", latent_levels=2,
               resolution_levels=4, n0=2, zdim0=2, image_size=(16, 16, 1),
               compute_dtype="float32", norm="batch", data_identifier="synthetic",
               synth_n_train=8, synth_n_val=4, synth_n_test=4, batch_size=4,
               validation_frequency=100, tensorboard_update_frequency=1,
               augment_on_device=False, do_image_summaries=False,
               do_histogram_summaries=False, async_checkpointing=False)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """2 steps of phiseg_tpu's Trainer; its log dir, JAX's restored state and model."""
    from phiseg_tpu.data import get_dataset as jax_get_dataset
    from phiseg_tpu.engine.checkpoint import CheckpointManager as JaxCheckpointManager
    from phiseg_tpu.engine.trainer import Trainer as JaxTrainer

    tmp = tmp_path_factory.mktemp("jax_run")
    cfg = JaxConfig(**JAX_RUN)
    log_dir = str(tmp / "log")
    with pytest.MonkeyPatch.context() as mp:  # the JAX trainer's advisory lock file
        mp.setenv("PHISEG_TPU_LOCK", str(tmp / "tpu.lock"))
        JaxTrainer(cfg, log_dir=log_dir).train(jax_get_dataset(cfg), num_iter=2)
    model = jax_build_model(cfg)
    tx = jax_make_optimizer(cfg)
    template = jax.eval_shape(lambda k: jax_create_train_state(model, cfg, k, tx),
                              jax.random.PRNGKey(0))
    jstate, step = JaxCheckpointManager(log_dir).restore(template, "latest")
    return dict(cfg=cfg, log_dir=log_dir, model=model, tx=tx, state=jstate, step=step)


def test_port_loads_a_jax_trainer_log_dir_with_adam_state(jax_run):
    cfg, model, state, step = load_experiment(jax_run["log_dir"], "latest", device="cpu")
    jstate = jax_run["state"]
    assert step == jax_run["step"] == 2 and state.step == int(jstate.step) == 2
    adam = jstate.opt_state[0]
    bs = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    mu = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, adam.mu),
                             "batch_stats": bs}, model)
    nu = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, adam.nu),
                             "batch_stats": bs}, model)
    for name, p in model.named_parameters():
        st_ = state.optimizer.state[p]
        assert float(st_["step"]) == int(adam.count) == 2
        assert torch.equal(st_["exp_avg"], mu[name]) and torch.equal(st_["exp_avg_sq"], nu[name])
    params = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.variables), model)
    for name, t in model.state_dict().items():
        assert torch.equal(t, params[name]), name


def test_jax_log_dir_samples_and_one_more_step_match_jax(jax_run):
    """Sample probabilities on injected noise within TOL; one further train
    step in each package: the loss within 1e-4 relative, and Adam's moments
    after it (0.9 of the carried ones plus 0.1 of the step's gradient) per
    tensor within 1e-3 of its largest entry, as the gradients are
    (tests/test_torch_train.py), with the count at 3 on both sides."""
    jcfg, jmodel, jstate = jax_run["cfg"], jax_run["model"], jax_run["state"]
    cfg, model, state, _ = load_experiment(jax_run["log_dir"], "latest", device="cpu")
    rng = np.random.RandomState(3)
    x = rng.randn(4, 16, 16, 1).astype(np.float32)
    s = (rng.rand(4, 16, 16) > 0.6).astype(np.int32)

    key, n = jax.random.PRNGKey(5), 3
    want = jax_make_sample_fn(jmodel, n)(jstate.variables, jnp.asarray(x), key)
    per_draw = []
    for k in jax.random.split(key, n):
        z, m, sg = jmodel.apply(jstate.variables, jnp.asarray(x), k, method="prior_draw")
        per_draw.append([(np.asarray(a) - np.asarray(b)) / np.asarray(c) for a, b, c in zip(z, m, sg)])
    eps = [torch.from_numpy(np.stack([d[i] for d in per_draw])) for i in range(len(per_draw[0]))]
    got = make_sample_fn(model, n)(torch.from_numpy(x), eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    key = jax.random.PRNGKey(6)
    s_oh = jax.nn.one_hot(jnp.asarray(s), 2)
    out = jmodel.apply(jstate.variables, jnp.asarray(x), s_oh, key, train=True,
                       mutable=["batch_stats"])[0]
    eps = [torch.from_numpy(np.array((z - m) / sg)) for z, m, sg in zip(out.z, out.q_mu, out.q_sigma)]
    jstep = jax_make_train_step(jmodel, jcfg, jax_run["tx"], use_fused_ce=False, donate=False)
    jnew, jld = jstep(jstate, jnp.asarray(x), jnp.asarray(s), key)
    tld = make_train_step(cfg, use_fused_ce=False)(state, torch.from_numpy(x),
                                                   torch.from_numpy(s), eps=eps)
    np.testing.assert_allclose(float(tld["total_loss"]), float(jld["total_loss"]), rtol=1e-4)
    adam = jnew.opt_state[0]
    assert int(adam.count) == 3 and state.step == 3
    bs = jax.tree_util.tree_map(np.asarray, jnew.batch_stats)
    mu = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, adam.mu),
                             "batch_stats": bs}, model)
    for name, p in model.named_parameters():
        st_ = state.optimizer.state[p]
        assert float(st_["step"]) == 3.0
        scale = float(mu[name].abs().max()) + 1e-12
        assert float((st_["exp_avg"] - mu[name]).abs().max()) <= 1e-3 * scale, name
