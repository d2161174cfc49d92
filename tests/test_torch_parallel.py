"""The port's data parallelism on the CPU: two gloo ranks against the JAX
package on one device, and against the port on one rank.

Both packages get the same seed-made numpy inputs and the same weights
(flax variables converted by phiseg_tpu_torch.convert). The two ranks are
spawned once for the module, each with a timeout of 120 s, and run every
case in one pass (`_rank_work`); the tests read their results.

The gradient convention: every rank computes the same global loss, the
differentiable all_reduce sums cotangents in its backward, so a rank's
gradient is its share of the gradient of the SUM over ranks of that loss;
the train step averages the gradients over the ranks. Held here: the
averaged gradients equal the JAX single-device gradients (a doubled or
halved gradient fails, which Adam's update would hide), and K3's per-rank
gradient is N times JAX's shard of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phiseg_tpu.engine.config import ExperimentConfig as JaxConfig
from phiseg_tpu.engine.train import TrainState as JaxTrainState
from phiseg_tpu.engine.train import build_model as jax_build_model
from phiseg_tpu.engine.train import make_optimizer as jax_make_optimizer
from phiseg_tpu.engine.train import make_train_step as jax_make_train_step
from phiseg_tpu.ops.fused_residual_ce import fused_residual_ce_dp as jax_fused_residual_ce_dp
from phiseg_tpu.parallel import make_mesh as jax_make_mesh
from phiseg_tpu_torch.convert import flax_to_state_dict
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.train import TrainState, build_model, make_optimizer, make_train_step
from phiseg_tpu_torch.nn.layers import BatchNorm, set_batch_norm_mesh
from phiseg_tpu_torch.ops.fused_residual_ce import fused_residual_ce_dp
from phiseg_tpu_torch.parallel import Mesh, make_mesh, shard_array, shard_train_step, spawn_ranks

torch.set_num_threads(1)
WORLD = 2
TIMEOUT = 120
# the tiny_cfg of tests/test_parallel.py
CFG = dict(model_family="phiseg", latent_levels=2, resolution_levels=4, n0=2, zdim0=2,
           image_size=(16, 16, 1), compute_dtype="float32", norm="batch", batch_size=8,
           lr_schedule={0: 1e-3})
BN_C = 3
K3_W = np.array([1.0, 2.0, 0.5], np.float32)


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


def _f64_step(payload, mesh=None):
    """The train step in f64 (compute dtype f64, model.double(), plain CE)
    from the payload's weights, on the whole batch or on this rank's shard:
    losses, gradients before the optimiser, BN running statistics."""
    cfg = ExperimentConfig(**dict(CFG, compute_dtype="float64"))
    model = build_model(cfg, device="cpu").double()
    model.load_state_dict(payload["state_dict"])
    state = TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()))
    step = make_train_step(cfg, use_fused_ce=False, mesh=mesh)
    if mesh is not None:
        step, state = shard_train_step(step, state, mesh)

    def part(a):
        return torch.from_numpy(np.array(a if mesh is None else shard_array(a, mesh)))

    losses = step(state, part(payload["x"]).double(), part(payload["s"]),
                  eps=[part(e).double() for e in payload["eps"]])
    return ({k: float(v) for k, v in losses.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers() if "running" in n})


def _rank_work(payload, log_dir):
    """Everything the ranks run, in one process group (runs in a spawned process)."""
    torch.set_num_threads(1)
    from phiseg_tpu_torch.engine.trainer import Trainer

    mesh = make_mesh(device="cpu")
    out = {"rank": mesh.rank}
    try:
        make_mesh(WORLD + 1, device="cpu")
    except ValueError as e:
        out["mesh_too_big"] = str(e)

    # sync-BN: local output, input gradient, parameter gradients, running stats
    bn = BatchNorm(BN_C)
    bn.load_state_dict(payload["bn_state"])
    set_batch_norm_mesh(bn, mesh)
    xb = torch.from_numpy(shard_array(payload["bn_x"], mesh)).requires_grad_(True)
    y = bn(xb)
    (y * torch.from_numpy(shard_array(payload["bn_gy"], mesh))).sum().backward()
    out["bn"] = dict(y=y.detach(), gx=xb.grad, gw=bn.weight.grad, gb=bn.bias.grad,
                     mean=bn.running_mean.clone(), var=bn.running_var.clone())

    # K3: value and gradient of sum(w * per-level CE) on this rank's shard
    lg = torch.from_numpy(np.ascontiguousarray(payload["k3_logits"][:, shard_array(
        np.arange(CFG["batch_size"]), mesh)])).requires_grad_(True)
    k3 = fused_residual_ce_dp(lg, torch.from_numpy(shard_array(payload["k3_s_oh"], mesh)), mesh)
    (k3 * torch.from_numpy(K3_W)).sum().backward()
    out["k3"] = dict(value=k3.detach(), grad=lg.grad)

    # one data-parallel train step (K3 path, no augmentation, injected eps)
    cfg = ExperimentConfig(**CFG)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(payload["state_dict"])
    state = TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()))
    step, state = shard_train_step(make_train_step(cfg, use_fused_ce=True, mesh=mesh), state, mesh)
    losses = step(state, torch.from_numpy(shard_array(payload["x"], mesh)),
                  torch.from_numpy(shard_array(payload["s"], mesh)),
                  eps=[torch.from_numpy(shard_array(e, mesh)) for e in payload["eps"]])
    out["losses"] = {k: float(v) for k, v in losses.items()}
    out["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()}
    out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    out["f64"] = _f64_step(payload, mesh)

    # the trainer's per-rank generator and rank-0-only outputs
    tcfg = ExperimentConfig(**dict(CFG, data_identifier="synthetic", experiment_name="dp"))
    trainer = Trainer(tcfg, log_dir=log_dir, mesh=mesh)
    out["noise"] = torch.rand(16, generator=trainer.generator)
    out["has_writer"] = trainer.writer is not None
    return out


@pytest.fixture(scope="module")
def ref():
    rng = np.random.RandomState(0)
    x = rng.randn(8, 16, 16, 1).astype(np.float32)
    s = (rng.rand(8, 16, 16) > 0.5).astype(np.int32)
    jcfg = JaxConfig(**CFG)
    jmodel = jax_build_model(jcfg)
    tx = jax_make_optimizer(jcfg)
    s_oh = jax.nn.one_hot(jnp.asarray(s), 2)
    variables = _jax_variables(jmodel, jnp.asarray(x), s_oh, rng)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
    key = jax.random.PRNGKey(1)
    fwd = jmodel.apply(variables, jnp.asarray(x), s_oh, key, train=True, mutable=["batch_stats"])[0]
    eps = [np.asarray((z - m) / sg) for z, m, sg in zip(fwd.z, fwd.q_mu, fwd.q_sigma)]
    jstep = jax_make_train_step(jmodel, jcfg, tx, use_fused_ce=False, donate=False)
    jstate, jld = jstep(jstate, jnp.asarray(x), jnp.asarray(s), key)

    tmodel = build_model(ExperimentConfig(**CFG), device="cpu")
    # Adam's first moment after one step is (1 - b1) * grad
    mu = jax.tree_util.tree_map(lambda m: np.asarray(m) / 0.1, jstate.opt_state[0].mu)
    grads = flax_to_state_dict({"params": mu, "batch_stats": variables["batch_stats"]}, tmodel)
    after = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.variables), tmodel)

    k3_logits = (rng.randn(3, 8, 16, 16, 2) * 2).astype(np.float32)
    k3_s_oh = np.eye(2, dtype=np.float32)[(rng.rand(8, 16, 16) > 0.5).astype(np.int64)]
    jmesh = jax_make_mesh(WORLD)
    k3_value = np.asarray(jax_fused_residual_ce_dp(jnp.asarray(k3_logits), jnp.asarray(k3_s_oh), jmesh))
    k3_grad = np.asarray(jax.grad(lambda lg: jnp.sum(jnp.asarray(K3_W) * jax_fused_residual_ce_dp(
        lg, jnp.asarray(k3_s_oh), jmesh)))(jnp.asarray(k3_logits)))

    bn_x = (rng.randn(8, BN_C, 5, 5) * 2 + 1).astype(np.float32)
    bn_gy = rng.randn(8, BN_C, 5, 5).astype(np.float32)
    bn_state = {"weight": torch.from_numpy(rng.uniform(0.5, 1.5, BN_C).astype(np.float32)),
                "bias": torch.from_numpy(rng.randn(BN_C).astype(np.float32)),
                "running_mean": torch.from_numpy(rng.randn(BN_C).astype(np.float32)),
                "running_var": torch.from_numpy(rng.uniform(0.5, 1.5, BN_C).astype(np.float32))}
    payload = dict(x=x, s=s, eps=eps, state_dict=flax_to_state_dict(variables, tmodel),
                   k3_logits=k3_logits, k3_s_oh=k3_s_oh, bn_x=bn_x, bn_gy=bn_gy, bn_state=bn_state)
    return dict(payload=payload, losses={k: float(v) for k, v in jld.items()}, grads=grads,
                after=after, k3_value=k3_value, k3_grad=k3_grad)


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp("dp_log"))
    outs = spawn_ranks(_rank_work, WORLD, (ref["payload"], log_dir), backend="gloo",
                       timeout=TIMEOUT)
    return outs, log_dir


def _cat(outs, *path):
    def get(o):
        for p in path:
            o = o[p]
        return o
    return torch.cat([get(o) for o in outs]).numpy()


def test_make_mesh_raises_beyond_the_available_devices(ranks):
    outs, _ = ranks
    assert [o["rank"] for o in outs] == [0, 1]
    for o in outs:
        assert "requested 3 devices, only 2 available" in o["mesh_too_big"]
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")  # this process has no group


def test_two_rank_train_step_matches_jax_on_one_device(ranks, ref):
    """Losses rtol 1e-4 and gradients before the optimiser within 1e-3 of
    each tensor's largest entry, as tests/test_parallel.py holds the JAX mesh
    step: f32 round-off through ~25 convolutions and sync-BN over as few as
    8 values per channel. Running statistics: one step's update, rtol 1e-4."""
    outs, _ = ranks
    for o in outs:
        assert sorted(o["losses"]) == sorted(ref["losses"])
        for k, want in ref["losses"].items():
            np.testing.assert_allclose(o["losses"][k], want, rtol=1e-4, err_msg=k)
    got = outs[0]["grads"]
    assert sorted(got) == sorted(n for n in ref["grads"] if not n.endswith(("running_mean", "running_var")))
    for name, g in got.items():
        want = ref["grads"][name]
        scale = float(want.abs().max()) + 1e-12
        err = float((g - want).abs().max())
        assert err <= 1e-3 * scale, (name, err, scale)
    for name, t in outs[0]["state"].items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), ref["after"][name].numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=name)


def test_two_rank_step_matches_one_rank_in_f64(ranks, ref):
    """In f64 the 2-rank step (sync-BN, K3's all_reduce, gradient averaging)
    and the 1-rank step on the whole batch are one function evaluated in
    another order: losses, every gradient tensor and the running statistics
    agree within 1e-9 of the tensor's largest entry. What separates them in
    f32 is round-off, not the data-parallel path."""
    outs, _ = ranks
    ld1, gr1, rs1 = _f64_step(ref["payload"])
    for o in outs:
        ld2, gr2, rs2 = o["f64"]
        assert sorted(ld2) == sorted(ld1)
        for k in ld1:
            assert abs(ld2[k] - ld1[k]) <= 1e-9 * abs(ld1[k]), (k, ld2[k], ld1[k])
        for name, want in list(gr1.items()) + list(rs1.items()):
            got = gr2[name] if name in gr2 else rs2[name]
            assert got.dtype == torch.float64, name
            err = float((got - want).abs().max())
            assert err <= 1e-9 * float(want.abs().max()), (name, err)


def test_rank_states_are_bitwise_equal_after_the_step(ranks):
    """Both ranks apply Adam to the same all-reduced gradients and update
    BN from the same all-reduced statistics."""
    outs, _ = ranks
    a, b = outs[0]["state"], outs[1]["state"]
    assert sorted(a) == sorted(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    for name in outs[0]["grads"]:
        assert torch.equal(outs[0]["grads"][name], outs[1]["grads"][name]), name


def test_k3_matches_jax_fused_residual_ce_dp(ranks, ref):
    """Value on every rank = JAX K3 on make_mesh(2), rtol 1e-5 (f32 sums of
    ~500 values in another order). Gradient: a rank's is N times JAX's on
    its shard (see the module notes), atol 1e-6 of O(1e-2) entries."""
    outs, _ = ranks
    for o in outs:
        np.testing.assert_allclose(o["k3"]["value"].numpy(), ref["k3_value"], rtol=1e-5)
    grad = np.concatenate([o["k3"]["grad"].numpy() for o in outs], axis=1)
    np.testing.assert_allclose(grad / WORLD, ref["k3_grad"], rtol=1e-4, atol=1e-6)


def test_sync_bn_two_ranks_match_one_rank(ranks, ref):
    """Sync-BN over 2 ranks vs the module without a mesh over the whole
    batch: output, input gradient, parameter gradients (summed over the
    ranks, as averaging the ranks' shares of the sum's gradient undoes the
    world size) and running statistics. rtol 1e-5: E[x^2] - E[x]^2 vs
    F.batch_norm's variance in f32 over 200 values per channel."""
    outs, _ = ranks
    p = ref["payload"]
    bn = BatchNorm(BN_C)
    bn.load_state_dict(p["bn_state"])
    x = torch.from_numpy(p["bn_x"]).requires_grad_(True)
    y = bn(x)
    (y * torch.from_numpy(p["bn_gy"])).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_cat(outs, "bn", "y"), y.detach().numpy(), **tol)
    np.testing.assert_allclose(_cat(outs, "bn", "gx"), x.grad.numpy(), **tol)
    for k, want in (("gw", bn.weight.grad), ("gb", bn.bias.grad)):
        got = sum(o["bn"][k] for o in outs)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    for o in outs:
        np.testing.assert_allclose(o["bn"]["mean"].numpy(), bn.running_mean.numpy(), **tol)
        np.testing.assert_allclose(o["bn"]["var"].numpy(), bn.running_var.numpy(), **tol)


def test_ranks_draw_different_noise_and_only_rank0_writes(ranks):
    outs, log_dir = ranks
    a, b = outs[0]["noise"], outs[1]["noise"]
    assert not torch.equal(a, b)
    # rank 0 draws what a run without a mesh draws
    from phiseg_tpu_torch.engine.trainer import rank_seed

    cfg = ExperimentConfig(**CFG)
    assert torch.equal(a, torch.rand(16, generator=torch.Generator().manual_seed(
        rank_seed(cfg.seed + 1, 0))))
    assert rank_seed(cfg.seed + 1, 0) == cfg.seed + 1
    assert [o["has_writer"] for o in outs] == [True, False]
    import os

    assert os.path.exists(os.path.join(log_dir, "config.json"))


def test_batch_norm_with_a_mesh_but_no_process_group_raises():
    bn = BatchNorm(2)
    set_batch_norm_mesh(bn, Mesh(group=None, rank=0, world_size=2, device=torch.device("cpu")))
    with pytest.raises(RuntimeError, match="no process group"):
        bn(torch.randn(4, 2, 3, 3))
    bn.eval()  # eval mode reads the running statistics and needs no group
    assert bn(torch.randn(4, 2, 3, 3)).shape == (4, 2, 3, 3)


def test_shard_array_slices_and_raises_on_an_uneven_batch():
    mesh = Mesh(group=None, rank=1, world_size=2, device=torch.device("cpu"))
    np.testing.assert_array_equal(shard_array(np.arange(8), mesh), np.arange(4, 8))
    with pytest.raises(ValueError, match="does not split"):
        shard_array(np.arange(7), mesh)


def test_shard_train_step_needs_a_step_built_for_the_mesh():
    mesh = Mesh(group=None, rank=0, world_size=2, device=torch.device("cpu"))
    cfg = ExperimentConfig(**CFG)
    with pytest.raises(ValueError, match="make_train_step"):
        shard_train_step(make_train_step(cfg), None, mesh)
