"""The port's Hierarchical Probabilistic U-Net (family "hpu_net") against the
repository's plain reference of it (reference_torch/hpunet.py) on the CPU,
in float32 at 32x32, n0=4, R=5, L=2, on seeded random weights: the
sampler's probabilities under injected noise, the training forward's KL a
level, reconstruction terms, GECO loss and every gradient from one
generator, three steps of the multiplier and the moving average through
make_train_step, a checkpoint round trip of both, the top-k mask, the
published widths' parameters against the benchmark's reference, and a
Trainer run with validations and test_quantitative through the CLIs."""

import json
import math
import os

import numpy as np
import pytest
import torch

from phiseg_tpu_torch.cli.test_quantitative import main as quant_main
from phiseg_tpu_torch.cli.train import main as train_main
from phiseg_tpu_torch.engine.checkpoint import CheckpointManager, host_snapshot
from phiseg_tpu_torch.engine.objective import geco_objective, top_k_mask
from phiseg_tpu_torch.engine.train import (
    TrainState,
    build_model,
    create_train_state,
    make_optimizer,
    make_sample_fn,
    make_train_step,
)
from phiseg_tpu_torch.experiments import get_experiment
from phiseg_tpu_torch.models.hpunet import TOP_K_SHARE, HPUNet
from phiseg_tpu_torch.nn.losses import one_hot
from reference_torch import hpunet as R

torch.set_num_threads(1)
TINY = dict(resolution_levels=5, latent_levels=2, n0=4, image_size=(32, 32, 1), batch_size=4,
            compute_dtype="float32")
RTOL = 1e-5  # float32 round-off between two orders of the same sums


@pytest.fixture
def cfg():
    return get_experiment("hpunet_synth").replace(**TINY)


def _as_dict(cfg):
    return json.loads(cfg.to_json())


def _random_weights_(model, seed):
    """Kernels of std 1 / sqrt(fan_in) and biases of std 0.1, so that the
    logits and the latents are far from flat (the published initialisers
    give near-constant logits; at He normal's scale the residual sums
    overflow exp(log sigma) at this depth)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "geco.lagmul":
                continue
            fan_in = math.prod(p.shape[1:]) if p.ndim > 1 else 0
            std = math.sqrt(1.0 / fan_in) if fan_in else 0.1
            p.copy_(torch.randn(p.shape, generator=g) * std)
    return model


def _model(cfg, seed=0):
    return _random_weights_(build_model(cfg, "cpu"), seed)


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _batch(seed, b=4):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, 32, 32, 1), generator=g)
    s = (x[..., 0] + 0.5 * torch.randn((b, 32, 32), generator=g) > 0).long()
    return x, s


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_sampler_probabilities_match_the_reference(cfg):
    model = _model(cfg, 1)
    x, _ = _batch(2, b=2)
    g = torch.Generator().manual_seed(3)
    eps = [torch.randn((5, *shape), generator=g) for shape in model.latent_shapes(2)]
    assert [tuple(e.shape) for e in eps] == [(5, 2, 4, 4, 1), (5, 2, 2, 2, 1)]
    got = make_sample_fn(model, 5)(x, eps=eps)
    want = R.sample_probs(_as_dict(cfg), _params(model), x, eps)
    assert got.shape == want.shape == (5, 2, 32, 32, 2)
    assert float((got - want).abs().max()) <= RTOL
    # the draws differ, and the logits are not flat
    assert float(want[..., 1].std(0).mean()) > 1e-2 and float(want[..., 1].std()) > 0.1


def test_training_forward_losses_and_gradients_match_the_reference(cfg):
    model = _model(cfg, 4)
    model.train()
    x, s = _batch(5)
    g = torch.Generator().manual_seed(6)
    s_oh = one_hot(s, cfg.nlabels)
    loss, got = geco_objective(model(x, s_oh, generator=g), s_oh, model, g)
    loss.backward()
    gr = torch.Generator().manual_seed(6)
    want, grads, _ = R.grad_step(_as_dict(cfg), _params(model), x, s,
                                 lambda shape: torch.randn(shape, generator=gr), gr)
    assert sorted(got) == sorted(k for k in want if k != "mask")
    assert set(got) >= {"kl_0", "kl_1", "kl_sum", "rec_loss_sum", "rec_loss_mean",
                        "ma_rec_loss_mean", "num_valid_pixels", "lagmul", "total_loss"}
    for k in got:
        assert abs(float(got[k].detach()) - float(want[k])) <= RTOL * abs(float(want[k])), k
    assert float(got["num_valid_pixels"]) == math.floor(TOP_K_SHARE * 4 * 32 * 32) / 4
    names = list(grads)
    assert names == [n for n, _ in model.named_parameters()]
    prog = dict(model.named_parameters())
    # the posterior's blocks after its last draw feed nothing: no gradient
    unused = [n for n in names if prog[n].grad is None]
    assert unused and all(n.startswith("posterior.dec1_block") for n in unused)
    assert all(float(grads[n].abs().max()) == 0.0 for n in unused)
    flat_got = torch.cat([(torch.zeros_like(prog[n]) if n in unused else prog[n].grad).reshape(-1)
                          for n in names])
    flat_want = torch.cat([grads[n].reshape(-1) for n in names])
    assert _rel(flat_got, flat_want) <= RTOL
    assert float(prog["geco.lagmul"].grad) == pytest.approx(float(grads["geco.lagmul"]), rel=RTOL)
    assert float(grads["geco.lagmul"]) < 0  # a positive constraint raises the multiplier


@pytest.mark.parametrize("lagmul0", [1.0, -0.01])
def test_three_steps_of_the_multiplier_and_the_moving_average(cfg, lagmul0):
    """make_train_step's Adam, the gradient's -RATE scale and the clamp at 0
    (from -0.01 the first step clamps) against the reference's."""
    model = _model(cfg, 7)
    with torch.no_grad():
        model.geco.lagmul.fill_(lagmul0)
    params = _params(model)
    state = TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()))
    step = make_train_step(cfg)
    names = R.trainable(R.param_spec(_as_dict(cfg)))
    adam, rstate = R.Adam(params, names), R.train_state(params)
    g, gr = torch.Generator().manual_seed(8), torch.Generator().manual_seed(8)
    seen = []
    for i in range(3):
        x, s = _batch(10 + i)
        losses = step(state, x, s, g)
        want, grads, rstate = R.grad_step(_as_dict(cfg), params, x, s,
                                          lambda shape: torch.randn(shape, generator=gr), gr, rstate)
        adam.step(params, grads, cfg.lr_schedule[0])
        geco = model.geco
        assert float(losses["total_loss"]) == pytest.approx(float(want["total_loss"]), rel=RTOL)
        assert float(geco.lagmul.detach()) == pytest.approx(float(params["geco.lagmul"]), rel=RTOL,
                                                            abs=1e-7)
        assert float(geco.ma_hidden) == pytest.approx(float(rstate["ma_hidden"]), rel=RTOL)
        assert int(geco.ma_count) == int(rstate["ma_count"]) == i + 1
        seen.append(float(geco.lagmul.detach()))
    assert min(seen) >= 0.0 and seen[2] > seen[1]
    if lagmul0 < 0:
        assert seen[0] == 0.0


def test_a_checkpoint_carries_the_multiplier_and_the_moving_average(cfg, tmp_path):
    state = create_train_state(cfg, device="cpu", seed=0)
    step = make_train_step(cfg)
    g = torch.Generator().manual_seed(0)
    for i in range(2):
        step(state, *_batch(20 + i), g)
    geco = dict(state.model.geco.state_dict(keep_vars=False))
    assert int(geco["ma_count"]) == 2 and float(geco["lagmul"]) != 1.0
    writer = CheckpointManager(str(tmp_path))
    writer.save(host_snapshot(state, g), "latest")
    fresh = create_train_state(cfg, device="cpu", seed=1)
    g2 = torch.Generator()
    _, at = CheckpointManager(str(tmp_path)).restore(fresh, "latest", generator=g2)
    assert at == 2
    for k, v in fresh.model.geco.state_dict().items():
        assert torch.equal(v, geco[k]), k
    # the next step of the restored run is the next step of the first
    x, s = _batch(30)
    a, b = step(state, x, s, g), make_train_step(cfg)(fresh, x, s, g2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(state.model.geco.lagmul, fresh.model.geco.lagmul)


@pytest.mark.parametrize("shape", [(4, 32, 32), (3, 17, 19), (2, 5, 5)])
def test_the_top_k_mask_selects_exactly_k_pixels(shape):
    g = torch.Generator().manual_seed(0)
    xe = torch.rand(shape, generator=g).reshape(-1)
    xe[::3] = 0.0  # zero losses (log 0) are pixels like any other
    mask = top_k_mask(xe, g)
    k = math.floor(TOP_K_SHARE * xe.numel())
    assert mask.shape == xe.shape and float(mask.sum()) == k
    assert set(mask.unique().tolist()) <= {0.0, 1.0}
    # the draw favours the large losses
    if k >= 10:
        assert float(xe[mask > 0].mean()) > float(xe.mean())


def test_the_published_widths_are_the_benchmark_reference_s():
    from portbench.reference import hpunet as PR

    cfg = _as_dict(get_experiment("hpunet"))
    with torch.device("meta"):
        model = HPUNet(zdim0=1, n0=24, latent_levels=4, resolution_levels=8, nlabels=2,
                       norm="none")
    have = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    assert have == [(n, shape) for n, shape, _ in PR.param_spec(cfg)]
    assert have == [(n, shape) for n, shape, _ in R.param_spec(cfg)]
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(math.prod(s) for name, s, _ in PR.param_spec(cfg)
                    if name in PR.trainable(PR.param_spec(cfg))) == 21_877_231
    assert model.latent_shapes(8) == ((8, 8, 8, 1), (8, 4, 4, 1), (8, 2, 2, 1), (8, 1, 1, 1))
    # c = 24 (1, 2, 4, 8, 8, 8, 8, 8), d = c / 2, 72 channels into the 128x128 level
    assert model.prior.enc7_block2.conv0.conv.weight.shape == (96, 192, 3, 3)
    assert model.likelihood.level7_block0.conv0.conv.weight.shape == (12, 72, 3, 3)
    assert model.likelihood.logits.conv.weight.shape == (2, 24, 1, 1)


def test_the_published_initialisers(cfg):
    model = build_model(cfg, "cpu", seed=3)
    assert type(model) is HPUNet
    w = model.prior.enc1_block0.conv0.conv.weight.detach()
    w = w.reshape(w.shape[0], -1)  # (4, 36): orthonormal rows
    torch.testing.assert_close(w @ w.T, torch.eye(4), atol=1e-5, rtol=0)
    b = model.prior.enc1_block0.conv0.conv.bias.detach()
    assert float(b.abs().max()) <= 0.002 and float(b.abs().max()) > 0
    assert float(model.geco.lagmul.detach()) == 1.0 and int(model.geco.ma_count) == 0


def test_the_family_refuses_a_norm_and_an_odd_size():
    with pytest.raises(ValueError, match="no normalisation"):
        HPUNet(n0=4, latent_levels=2, resolution_levels=5, image_size=(32, 32), norm="batch")
    with pytest.raises(ValueError, match="divides"):
        HPUNet(n0=4, latent_levels=2, resolution_levels=5, image_size=(40, 36), norm="none")


def test_trainer_validation_and_test_quantitative_through_the_clis(cfg, tmp_path):
    """The Trainer with two validations (eval loss, metrics, diagnostics),
    the GECO summaries in metrics.jsonl, then 100-sample scoring."""
    c = cfg.replace(experiment_name="hpunet_tiny", synth_n_train=8, synth_n_val=4,
                    synth_n_test=4, validation_frequency=2, validation_samples=3,
                    validation_elbo_samples=2, tensorboard_update_frequency=1,
                    num_validation_images=4, do_image_summaries=False)
    path = str(tmp_path / "cfg.json")
    c.save(path)
    log_dir = str(tmp_path / "log")
    train_main([path, "--num-iter", "5", "--log-dir", log_dir, "--device", "cpu"])
    lines = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    batch = [r for r in lines if "batch_lagmul" in r]
    assert [r["step"] for r in batch] == [0, 1, 2, 3, 4]
    assert all(r["batch_ma_rec_loss_mean"] > 0 and r["batch_num_valid_pixels"] == 20.25
               for r in batch)
    assert [r["step"] for r in lines if "validation_GED" in r] == [2, 4]
    assert any("val_batch_kl_sum" in r for r in lines)
    quant_main([log_dir, "--samples", "100", "--batch", "2", "--device", "cpu"])
    npz = [f for f in os.listdir(log_dir) if f.startswith("ged100_")]
    ged = np.load(os.path.join(log_dir, npz[0]))["arr_0"]
    assert ged.shape == (4,) and np.isfinite(ged).all()


def test_the_family_s_spans(cfg):
    """Under a profiler: the sampler's `sample.decode.tile`, `.latents` and
    `.stitch` inside `sample.decode`, and the step's `train_step.geco`
    inside `train_step.forward`."""
    from phiseg_tpu_torch.utils.profiling import SPANS

    state = create_train_state(cfg, device="cpu", seed=0)
    step, sample = make_train_step(cfg), make_sample_fn(state.model, 3)
    g = torch.Generator().manual_seed(0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, *_batch(40), g)
        sample(_batch(41, b=2)[0], g)
    found = {(r.name, r.parent.name if r.parent else None) for r in SPANS.records()}
    assert found >= {("train_step.geco", "train_step.forward"),
                     ("sample.decode.tile", "sample.decode"),
                     ("sample.decode.latents", "sample.decode"),
                     ("sample.decode.stitch", "sample.decode")}
