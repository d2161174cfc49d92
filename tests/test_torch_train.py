"""The port's train step vs phiseg_tpu's make_train_step, and the port's
Trainer through its CLI, on the CPU.

Both sides start from the same weights (flax variables converted by
phiseg_tpu_torch.convert), run in f32 without augmentation, and draw the
same posterior noise: the port is given eps = (z - mu) / sigma of the JAX
forward with the step's key. Tolerances, with their reasons, are at each
assertion.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from phiseg_tpu.engine.config import ExperimentConfig as JaxConfig
from phiseg_tpu.engine.train import TrainState as JaxTrainState
from phiseg_tpu.engine.train import build_model as jax_build_model
from phiseg_tpu.engine.train import make_optimizer as jax_make_optimizer
from phiseg_tpu.engine.train import make_train_step as jax_make_train_step
from phiseg_tpu_torch.cli.train import main as cli_main
from phiseg_tpu_torch.convert import flax_to_state_dict
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.train import (
    TrainState,
    build_model,
    lr_schedule_from_dict,
    make_optimizer,
    make_train_step,
)

torch.set_num_threads(1)
STEPS = 3
LR = 1e-3
CFG = dict(model_family="phiseg", latent_levels=3, resolution_levels=5, n0=4, zdim0=2,
           image_size=(32, 32, 1), compute_dtype="float32", norm="batch", batch_size=4,
           lr_schedule={0: LR})


def _jax_variables(model, x, s_oh, rng):
    shapes = jax.eval_shape(lambda k: model.init({"params": k}, x, s_oh, k, train=True),
                            jax.random.PRNGKey(0))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            return (rng.randn(*leaf.shape) * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)  # scale, var

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def runs():
    """STEPS steps of each framework from one state; returns both histories."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 32, 32, 1).astype(np.float32)
    s = (rng.rand(4, 32, 32) > 0.6).astype(np.int32)
    jcfg = JaxConfig(**CFG)
    jmodel = jax_build_model(jcfg)
    tx = jax_make_optimizer(jcfg)
    s_oh = jax.nn.one_hot(jnp.asarray(s), 2)
    variables = _jax_variables(jmodel, jnp.asarray(x), s_oh, rng)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
    jstep = jax_make_train_step(jmodel, jcfg, tx, use_fused_ce=False, donate=False)
    forward = jax.jit(lambda v, k: jmodel.apply(v, jnp.asarray(x), s_oh, k, train=True,
                                                mutable=["batch_stats"])[0])

    tcfg = ExperimentConfig(**CFG)
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_state_dict(flax_to_state_dict(variables, tmodel))
    tstate = TrainState(model=tmodel, optimizer=make_optimizer(tcfg, tmodel.parameters()))
    tstep = make_train_step(tcfg, use_fused_ce=False)

    hist = []
    for i in range(STEPS):
        key = jax.random.fold_in(jax.random.PRNGKey(1), i)
        out = forward(jstate.variables, key)
        eps = [torch.from_numpy(np.array((z - m) / sg))
               for z, m, sg in zip(out.z, out.q_mu, out.q_sigma)]
        jstate, jld = jstep(jstate, jnp.asarray(x), jnp.asarray(s), key)
        tld = tstep(tstate, torch.from_numpy(x), torch.from_numpy(s), eps=eps)
        rec = {"jax_losses": {k: float(v) for k, v in jld.items()},
               "torch_losses": {k: float(v) for k, v in tld.items()}}
        if i == 0:  # Adam's first moment after one step is (1 - b1) * grad
            mu = jstate.opt_state[0].mu
            rec["jax_m1"] = flax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, mu),
                                                "batch_stats": variables["batch_stats"]}, tmodel)
            opt = tstate.optimizer
            rec["torch_m1"] = {n: opt.state[p]["exp_avg"].clone()
                               for n, p in tmodel.named_parameters()}
            rec["torch_grad"] = {n: p.grad.clone() for n, p in tmodel.named_parameters()}
        hist.append(rec)
    final_jax = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.variables), tmodel)
    return hist, final_jax, tmodel.state_dict(), tstate


def test_loss_dicts_match_each_step(runs):
    hist, *_ = runs
    for i, rec in enumerate(hist):
        assert sorted(rec["jax_losses"]) == sorted(rec["torch_losses"])
        # step 0: f32 round-off of one forward (1e-4). Later steps start from
        # parameters that Adam may have moved by up to lr per step in
        # opposite directions (see below; measured 2.5e-3 after 3 steps),
        # which moved the 4x-weighted KL of level 1 by 6e-3: 2e-2
        rtol = 1e-4 if i == 0 else 2e-2
        for k, want in rec["jax_losses"].items():
            np.testing.assert_allclose(rec["torch_losses"][k], want, rtol=rtol,
                                       err_msg=f"step {i} {k}")


def test_step_one_gradients_match(runs):
    """Adam's first moment after step 1 is 0.1 * grad on both sides. Per
    tensor, within 1e-3 of its largest entry: f32 round-off through ~40
    convolutions forward and back, with train-mode batch norm over as few as
    8 values per channel."""
    hist, *_ = runs
    rec = hist[0]
    for name, got in rec["torch_m1"].items():
        want = rec["jax_m1"][name]
        scale = float(want.abs().max()) + 1e-12
        err = float((got - want).abs().max())
        assert err <= 1e-3 * scale, (name, err, scale)
        torch.testing.assert_close(rec["torch_grad"][name] * 0.1, got, rtol=1e-6, atol=1e-12)


def test_parameters_and_batch_stats_after_steps(runs):
    """Adam's update of a near-zero gradient is about +-lr whatever its
    size, so a gradient that is round-off on both sides can move a parameter
    by lr in opposite directions: parameters are held to atol lr * steps.
    Running statistics follow the forward: atol 1e-3."""
    _, final_jax, final_torch, tstate = runs
    assert tstate.step == STEPS
    assert sorted(final_jax) == sorted(final_torch)
    for name, want in final_jax.items():
        atol = 1e-3 if "running" in name else LR * STEPS
        np.testing.assert_allclose(final_torch[name].numpy(), want.numpy(), atol=atol, rtol=0,
                                   err_msg=name)


def test_lr_schedule_floor_lookup():
    sched = lr_schedule_from_dict({0: 1e-3, 100: 1e-4, 500: 1e-5})
    assert sched(0) == 1e-3 and sched(99) == 1e-3
    assert sched(100) == 1e-4 and sched(499) == 1e-4 and sched(10_000) == 1e-5


@pytest.mark.parametrize("name,cls,extra", [
    ("adam", torch.optim.Adam, {"betas": (0.9, 0.999), "eps": 1e-8}),
    ("momentum", torch.optim.SGD, {"momentum": 0.9, "nesterov": True}),
    ("sgd", torch.optim.SGD, {"momentum": 0}),
])
def test_make_optimizer_options(name, cls, extra):
    opt = make_optimizer(ExperimentConfig(optimizer=name), [torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(opt, cls)
    for k, v in extra.items():
        assert opt.param_groups[0][k] == v


def test_momentum_matches_optax_nesterov():
    """Two steps of Nesterov momentum on fixed gradients, torch vs optax."""
    g = [np.array([1.0, -2.0], np.float32), np.array([0.5, 0.25], np.float32)]
    p = torch.nn.Parameter(torch.zeros(2))
    opt = make_optimizer(ExperimentConfig(optimizer="momentum", lr_schedule={0: 0.1}), [p])
    tx = optax.sgd(0.1, momentum=0.9, nesterov=True)
    jp, st = jnp.zeros(2), tx.init(jnp.zeros(2))
    for gi in g:
        p.grad = torch.from_numpy(gi)
        opt.step()
        upd, st = tx.update(jnp.asarray(gi), st, jp)
        jp = optax.apply_updates(jp, upd)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6)


def _tiny_cfg(tmp_path, **kw):
    cfg = ExperimentConfig(**dict(CFG, experiment_name="tiny_synth", data_identifier="synthetic",
                                  compute_dtype="bfloat16", synth_n_train=8, synth_n_val=4,
                                  synth_n_test=4, tensorboard_update_frequency=1, **kw))
    path = tmp_path / "config.json"
    cfg.save(str(path))
    return str(path)


def test_trainer_two_steps_through_the_cli(tmp_path):
    log_dir = tmp_path / "log"
    trainer = cli_main([_tiny_cfg(tmp_path), "--num-iter", "2", "--log-dir", str(log_dir),
                        "--device", "cpu"])
    recs = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    for r in recs:
        assert all(math.isfinite(v) for k, v in r.items() if k.startswith("batch_")), r
        assert "batch_residual_multinoulli_loss_lvl2" in r and "batch_KL_divergence_loss_lvl0" in r
        assert r["learning_rate"] == LR
    assert recs[1]["images_per_sec"] > 0
    assert ExperimentConfig.load(str(log_dir / "config.json")).experiment_name == "tiny_synth"
    assert trainer.state.step == 2
    assert list(log_dir.glob("events.out.tfevents.*"))


def test_cli_mesh_trains_two_ranks_on_the_cpu(tmp_path):
    """--mesh 2 --device cpu: two gloo ranks split the batch of 4; rank 0
    alone writes the global losses (timeout 120 s for the ranks). On the CPU
    the kernels' plain version runs, so no rank counts a launch."""
    log_dir = tmp_path / "log"
    ranks = cli_main([_tiny_cfg(tmp_path), "--num-iter", "2", "--log-dir", str(log_dir),
                      "--device", "cpu", "--mesh", "2"], timeout=120)
    assert [step for step, _ in ranks] == [2, 2]
    for _, launches in ranks:
        assert sorted(launches) == ["fused_residual_ce_bwd", "fused_residual_ce_dp",
                                    "fused_residual_ce_fwd"]
        assert not any(launches.values()), launches
    recs = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    for r in recs:
        assert all(math.isfinite(v) for k, v in r.items() if k.startswith("batch_")), r
    assert len(list(log_dir.glob("events.out.tfevents.*"))) == 1


def test_cli_distributed_joins_the_group_of_torchrun_env(tmp_path):
    """--distributed: two processes given torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT) train 2 steps on gloo together;
    each process has a timeout of 120 s."""
    import os
    import subprocess
    import sys

    from phiseg_tpu_torch.parallel.mesh import free_port

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    log_dir = tmp_path / "log"
    cmd = [sys.executable, "-m", "phiseg_tpu_torch.cli.train", _tiny_cfg(tmp_path),
           "--num-iter", "2", "--log-dir", str(log_dir), "--device", "cpu", "--distributed"]
    base = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1", WORLD_SIZE="2",
                MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
    procs = [subprocess.Popen(cmd, cwd=root, env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)[-3000:]
    recs = [json.loads(line) for line in (log_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 1]


def test_cli_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """The default device is cuda; without a card the CLI raises rather than
    train on the CPU, with or without --mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--device", "cuda"], ["--mesh", "2"]):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cli_main([_tiny_cfg(tmp_path), "--num-iter", "1", "--log-dir",
                      str(tmp_path / "log"), *extra])
    assert not (tmp_path / "log").exists()


@pytest.mark.parametrize("factory", ["build_model", "create_train_state"])
def test_model_factories_take_the_card_unless_asked_for_the_cpu(factory, monkeypatch):
    """With no device named, build_model and create_train_state put the
    model on the card and raise without one; device="cpu" builds there, with
    the same seeded weights as a second build."""
    from phiseg_tpu_torch.engine import train as engine_train

    build = getattr(engine_train, factory)
    cfg = ExperimentConfig(**CFG)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build(cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build(cfg, device="cuda", seed=0)
    models = [build(cfg, device="cpu", seed=0) for _ in range(2)]
    models = [m if factory == "build_model" else m.model for m in models]
    assert all(p.device.type == "cpu" for p in models[0].parameters())
    a, b = (m.state_dict() for m in models)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_prefetcher_hands_a_provider_error_to_the_consumer():
    from phiseg_tpu_torch.engine.trainer import _Prefetcher

    class Broken:
        def next_batch(self, batch_size):
            raise OSError("disk gone")

    prefetch = _Prefetcher(Broken(), 2)
    try:
        with pytest.raises(RuntimeError, match="prefetch") as info:
            prefetch.next()
        assert isinstance(info.value.__cause__, OSError)
    finally:
        prefetch.stop()
    assert not prefetch.t.is_alive()
