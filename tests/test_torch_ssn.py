"""The port's Stochastic Segmentation Networks (family "ssn") against the
repository's plain reference of it (reference_torch/ssn.py) on the CPU at
64x64, n0=4, R=5, rank 3, on seeded random weights: the distribution (mu,
W, D) and the sampler's probabilities under injected noise, the Monte Carlo
loss and its gradients, the antithetic pairs, the covariance's layout
against torch.distributions, the draws' empirical covariance, the sampler's
untiled cache, the sampler's and the eval's replayed CUDA graphs (eager
off the card; on the card, bit for bit the eager functions', a case that
skips without one), InferenceEngine's latent methods, the published widths
against both references, the spans, and a Trainer run with validations, a
checkpoint, a bitwise resume and test_quantitative through the CLI.

Tolerances, each with its reason:
  RTOL                1e-5  float32 round-off between two orders of the same
                            sums (the eval-mode forward and the draws;
                            measured ~1e-7);
  GRAD_TOL["float32"] 2e-2  float32 gradients: the train-mode batch norm of
                            the encoder's two finest levels amplifies
                            round-off to 1.2e-3 - 4.9e-3 of the all-parameter
                            norm at this size, which the float64 case shows
                            to be round-off;
  GRAD_TOL["float64"] 1e-9  float64 gradients: the two orders agree to ~5e-15."""

import json
import math
import os

import numpy as np
import pytest
import torch

from phiseg_tpu_torch.cli.test_quantitative import main as quant_main
from phiseg_tpu_torch.data import get_dataset
from phiseg_tpu_torch.engine import replay_graph
from phiseg_tpu_torch.engine.replay_graph import ReplayGraph
from phiseg_tpu_torch.engine.objective import antithetic_logits, ssn_objective
from phiseg_tpu_torch.engine.train import build_model, make_sample_fn, make_sample_levels_fn
from phiseg_tpu_torch.engine.train import create_train_state, make_train_step
from phiseg_tpu_torch.engine.trainer import Trainer
from phiseg_tpu_torch.experiments import get_experiment
from phiseg_tpu_torch.models import SSN, model_class
from phiseg_tpu_torch.models.ssn import EPS, MC_SAMPLES
from phiseg_tpu_torch.nn.losses import one_hot
from reference_torch import ssn as R

torch.set_num_threads(1)
TINY = dict(resolution_levels=5, n0=4, zdim0=3, image_size=(64, 64, 1), batch_size=4,
            compute_dtype="float32")
RTOL = 1e-5
GRAD_TOL = {"float32": 2e-2, "float64": 1e-9}


def _cfg(**kw):
    return get_experiment("ssn_synth").replace(**dict(TINY, **kw))


def _as_dict(cfg):
    return json.loads(cfg.to_json())


def _model(cfg, seed=0, dtype=torch.float32):
    """Kernels of std 1 / sqrt(fan_in), biases and BN affines of std 0.1,
    running statistics off 0 and 1, so that every head matters."""
    model = build_model(cfg, "cpu").to(dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            fan_in = math.prod(p.shape[1:]) if p.ndim > 1 else 0
            std = math.sqrt(1.0 / fan_in) if fan_in else 0.1
            p.copy_(torch.randn(p.shape, generator=g, dtype=dtype) * std
                    + (1.0 if name.endswith("bn.weight") else 0.0))
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g, dtype=dtype))
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g, dtype=dtype))
    return model


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _batch(seed, b=4, size=64, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, size, size, 1), generator=g, dtype=dtype)
    s = (x[..., 0] + 0.5 * torch.randn((b, size, size), generator=g, dtype=dtype) > 0).long()
    return x, s


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_the_registry_s_family_is_its_own_class():
    assert model_class("ssn") is SSN
    cfg = get_experiment("ssn")
    assert (cfg.model_family, cfg.zdim0, cfg.n0, cfg.resolution_levels, cfg.norm) == \
        ("ssn", 10, 32, 7, "batch")
    with pytest.raises(ValueError, match="nlabels >= 2"):
        SSN(n0=4, resolution_levels=3, image_size=(8, 8), nlabels=1)


@pytest.mark.parametrize("what", ["mean", "cov_factor", "cov_diag", "probs"])
def test_distribution_and_probabilities_match_the_reference(what):
    cfg = _cfg()
    model = _model(cfg, 1).eval()
    x, _ = _batch(2, b=2)
    g = torch.Generator().manual_seed(3)
    eps = [torch.randn((5, *shape), generator=g) for shape in model.latent_shapes(2)]
    assert [tuple(e.shape) for e in eps] == [(5, 2, 64, 64, 2), (5, 2, 3)]
    if what == "probs":
        got = make_sample_fn(model, 5)(x, eps=eps)
        want = R.sample_probs(_as_dict(cfg), _params(model), x, eps)
        assert got.shape == want.shape == (5, 2, 64, 64, 2)
        # the draws differ, and the probabilities are far from flat
        assert float(want[..., 1].std(0).mean()) > 1e-2 and float(want[..., 1].std()) > 0.1
    else:
        with torch.no_grad():
            mean, cov_factor, cov_diag = model.sample_cache(x)
        got = {"mean": mean, "cov_factor": cov_factor, "cov_diag": cov_diag}[what]
        want = dict(zip(("mean", "cov_factor", "cov_diag"),
                        R.distribution(_as_dict(cfg), _params(model), x)))[what]
        assert got.shape == want.shape
        assert got.shape[:2] == (2, 2 * 64 * 64)
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_loss_and_gradients_match_the_reference(dtype):
    """The summaries to RTOL and the all-parameter gradient relative L2 to
    GRAD_TOL, from one generator: eps_D, then eps_W, after the forward."""
    dt = getattr(torch, dtype)
    cfg = _cfg(compute_dtype=dtype)
    model = _model(cfg, 4, dt).train()
    params = _params(model)
    x, s = _batch(5, dtype=dt)
    g = torch.Generator().manual_seed(6)
    s_oh = one_hot(s, 2)
    loss, got = ssn_objective(model(x, s_oh, generator=g), s_oh, model, g)
    loss.backward()
    gr = torch.Generator().manual_seed(6)
    want, grads = R.grad_step(_as_dict(cfg), params, x, s,
                              lambda shape: torch.randn(shape, generator=gr, dtype=dt))
    assert sorted(got) == sorted(want) == ["ssn_ce_mean", "ssn_cov_diag_mean",
                                           "ssn_cov_factor_rms", "ssn_loglik", "total_loss"]
    for k in got:
        assert abs(float(got[k].detach()) - float(want[k])) <= RTOL * abs(float(want[k])), k
    # the untrained model's loss is an image's pixels' CE of its best draws
    assert float(want["total_loss"]) > 0.1 * 64 * 64
    assert torch.equal(g.get_state(), gr.get_state())  # the same draws, in the same order
    prog = dict(model.named_parameters())
    assert list(grads) == list(prog)
    flat_got = torch.cat([prog[n].grad.reshape(-1) for n in grads])
    flat_want = torch.cat([grads[n].reshape(-1) for n in grads])
    assert float((flat_got - flat_want).norm() / flat_want.norm()) <= GRAD_TOL[dtype]


def test_antithetic_pairs_sum_to_twice_the_mean():
    cfg = _cfg()
    model = _model(cfg, 7).train()
    x, s = _batch(8)
    out = model(x, one_hot(s, 2))
    g = torch.Generator().manual_seed(9)
    eps = [torch.randn((MC_SAMPLES // 2, *shape), generator=g) for shape in model.latent_shapes(4)]
    with torch.no_grad():
        eta = antithetic_logits(out, *eps)
        half = MC_SAMPLES // 2
        mu = out.mean
        r = eta[:half] - mu
    assert eta.shape == (MC_SAMPLES, 4, 2 * 64 * 64)
    # mu + r and mu - r, each rounded once: the pair's sum is 2 mu within
    # one ulp of |mu| + |r| a term
    ulp = torch.finfo(torch.float32).eps * (mu.abs() + r.abs())
    assert bool(((eta[:half] + eta[half:] - 2 * mu).abs() <= 2 * ulp).all())
    assert float(r.abs().mean()) > 0.1  # the draws move the logits


def test_the_covariance_s_layout_is_low_rank_normal_s():
    """At N = 2 x 8 x 8 = 128: torch.distributions.LowRankMultivariateNormal
    of the port's (mu, W, D) has the covariance built entry by entry from
    the heads' raw outputs, class-major over (C, H, W), the factor
    rank-major over the C R channels, D = exp(l) + 2 EPS."""
    cfg = _cfg(resolution_levels=3, image_size=(8, 8, 1), zdim0=3)
    model = _model(cfg, 10).eval()
    x, _ = _batch(11, b=1, size=8)
    with torch.no_grad():
        mean, factor, diag = model.sample_cache(x)
        lik = model.likelihood
        h = lik.recomb(lik.unet(x.permute(0, 3, 1, 2)))
        raw_f, raw_l = lik.cov_factor(h)[0], lik.log_cov_diag(h)[0]  # (C R, 8, 8), (C, 8, 8)
    C, rank, hw = 2, 3, 64
    idx = [(c, p) for c in range(C) for p in range(hw)]
    w = torch.tensor([[float(raw_f[r * C + c].reshape(-1)[p]) for r in range(rank)]
                      for c, p in idx], dtype=torch.float64)
    d = torch.tensor([math.exp(float(raw_l[c].reshape(-1)[p])) + 2 * EPS for c, p in idx],
                     dtype=torch.float64)
    want = w @ w.T + torch.diag(d)
    dist = torch.distributions.LowRankMultivariateNormal(mean[0].double(), factor[0].double(),
                                                         diag[0].double())
    assert dist.covariance_matrix.shape == (128, 128)
    torch.testing.assert_close(dist.covariance_matrix, want, rtol=RTOL, atol=RTOL)


def test_the_draws_empirical_covariance():
    """20,000 draws of N = 2 x 4 x 4 = 32 logits through the sampler: each
    entry of the empirical covariance within 5 of its standard errors,
    sqrt((S_ii S_jj + S_ij^2) / n), of W W^T + diag(D), and the mean within 5
    of sqrt(S_ii / n); with the factor dropped, the off-diagonal entries
    fail it."""
    cfg = _cfg(resolution_levels=3, image_size=(4, 4, 1), zdim0=3)
    model = _model(cfg, 12).eval()
    x, _ = _batch(13, b=1, size=4)
    n = 20_000
    with torch.no_grad():
        mean, factor, diag = (t[0].double() for t in model.sample_cache(x))
        logits = make_sample_levels_fn(model, n)(x, torch.Generator().manual_seed(14))[0]
    eta = logits[:, 0].permute(0, 3, 1, 2).reshape(n, -1).double()  # class-major
    sigma = factor @ factor.T + torch.diag(diag)
    var = torch.diag(sigma)
    err = torch.sqrt((var[:, None] * var[None, :] + sigma.square()) / n)
    emp = torch.cov(eta.T)
    assert float(((emp - sigma).abs() / err).max()) <= 5.0
    assert float(((eta.mean(0) - mean).abs() / torch.sqrt(var / n)).max()) <= 5.0
    off = ~torch.eye(32, dtype=torch.bool)
    assert float(((emp - torch.diag(diag)).abs() / err)[off].max()) > 5.0


def test_repeat_cache_returns_the_cache_without_a_copy():
    cfg = _cfg()
    model = _model(cfg).eval()
    with torch.no_grad():
        cache = model.sample_cache(_batch(15, b=2)[0])
    out = model.repeat_cache(cache, 100)
    assert out is cache
    assert [t.shape[0] for t in out] == [2, 2, 2]


def _eval_runs(model, cfg, x, ann, calls, seed, replayed):
    """Each call's (probabilities, GED^2, S_NCC, GED^2 terms) of the sampler
    and the eval of make_quant_eval_fn(model, cfg, 5) on x, each after
    `call(model)`, the draws from one generator state; the encoder and the
    metrics replayed from CUDA graphs where `replayed`, else eager."""
    from phiseg_tpu_torch.engine.validation import make_quant_eval_fn

    if not replayed:
        model.replay_sampler = False
    try:
        sample, quant = make_sample_fn(model, 5), make_quant_eval_fn(model, cfg, 5)
    finally:
        model.__dict__.pop("replay_sampler", None)
    out = []
    for call in calls:
        call(model)
        probs = sample(x, torch.Generator(device=x.device).manual_seed(seed))
        out.append((probs, *quant(x, ann, torch.Generator(device=x.device).manual_seed(seed))))
    return out


def test_the_replayed_sampler_runs_eagerly_off_the_card():
    """On the CPU SSN's sampler and eval run eagerly (nothing is captured)
    and give what the eager functions give."""
    cfg = _cfg(image_size=(32, 32, 1))
    model = _model(cfg, 21)
    x, ann = _batch(22, b=2, size=32)[0], torch.randint(0, 2, (2, 4, 32, 32))
    replay_graph.reset_counts()
    got = _eval_runs(model, cfg, x, ann, [lambda m: None], 23, replayed=True)
    want = _eval_runs(model, cfg, x, ann, [lambda m: None], 23, replayed=False)
    assert model.replay_sampler
    assert all(torch.equal(a, b) for a, b in zip(got[0], want[0]))
    assert replay_graph.COUNTS == {"captures": 0, "replays": 0}
    graph = ReplayGraph(lambda t: t + 1)
    with torch.no_grad():
        assert torch.equal(graph(x), x + 1)
    assert replay_graph.COUNTS == {"captures": 0, "replays": 0}


@pytest.mark.cuda
def test_the_replayed_sampler_on_the_card():
    """On the card SSN's sampler encoder and eval metrics are CUDA graphs,
    one a shape: the probabilities and metrics are the eager functions' bit
    for bit, also after the weights change in place (read by the graph),
    after a parameter's storage moves and after a TF32 switch (each
    captured again); each call returns tensors of its own; BN + ReLU
    launches are counted as the eager calls count them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs)")
    from phiseg_tpu_torch.ops import bn_act_eval

    cfg = _cfg(image_size=(32, 32, 1), compute_dtype="bfloat16")
    model = _model(cfg, 24).cuda()
    x = _batch(25, b=2, size=32)[0].cuda()
    ann = torch.randint(0, 2, (2, 4, 32, 32), generator=torch.Generator().manual_seed(26)).cuda()
    tf32 = torch.backends.cudnn.allow_tf32

    def nothing(m):
        pass

    def scale(m):
        with torch.no_grad():
            m.likelihood.mean.conv.weight.mul_(1.5)

    def move(m):
        w = m.likelihood.cov_factor.conv.weight
        w.data = w.data.clone()

    def switch(m):
        torch.backends.cudnn.allow_tf32 = not torch.backends.cudnn.allow_tf32

    calls = [nothing, nothing, scale, move, switch, nothing]
    try:
        state = _params(model)
        bn_act_eval.reset_launch_counts()
        eager = _eval_runs(model, cfg, x, ann, calls, 27, replayed=False)
        launches = bn_act_eval.LAUNCHES["bn_act_eval"]
        torch.backends.cudnn.allow_tf32 = tf32
        model.load_state_dict(state)
        replay_graph.reset_counts()
        bn_act_eval.reset_launch_counts()
        replayed = _eval_runs(model, cfg, x, ann, calls, 27, replayed=True)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert all(torch.equal(a, b) for r, e in zip(replayed, eager) for a, b in zip(r, e))
    assert not torch.equal(replayed[1][0], replayed[2][0])
    assert len({t.data_ptr() for r in replayed for t in r}) == 4 * len(calls)
    # the encoder twice a call (the sampler's and the eval's), captured again
    # when a parameter moves and when TF32 switches; the metrics once a call,
    # captured again when TF32 switches
    assert replay_graph.COUNTS == {"captures": 2 * 3 + 2, "replays": 3 * len(calls)}
    assert bn_act_eval.LAUNCHES["bn_act_eval"] == launches > 0


def test_the_inference_engine_s_latent_methods():
    """generate_prior_samples draws SSN's two noises from the standard
    normal, generate_samples_from_z decodes them to the sampler's logits of
    the same noise, and generate_posterior_samples refuses: SSN has no
    posterior."""
    from phiseg_tpu_torch.engine.inference import InferenceEngine

    cfg = _cfg(image_size=(32, 32, 1))
    model = _model(cfg, 18).eval()
    engine = InferenceEngine(cfg, model)
    x, s = _batch(19, b=2, size=32)
    z, mu, sigma = engine.generate_prior_samples(x, torch.Generator().manual_seed(20),
                                                 return_params=True)
    assert [tuple(t.shape) for t in z] == [(2, 32, 32, 2), (2, 3)]
    assert all(float(m.abs().max()) == 0.0 and float((v - 1).abs().max()) == 0.0
               for m, v in zip(mu, sigma))
    got = engine.generate_samples_from_z(z, x)
    want = make_sample_levels_fn(model, 1)(x, eps=[t[None] for t in z])[0][0]
    assert torch.equal(got, want)
    with pytest.raises(NotImplementedError, match="no posterior"):
        engine.generate_posterior_samples(x, s)


def test_the_published_widths_are_both_references():
    from portbench.reference import ssn as PR

    cfg = _as_dict(get_experiment("ssn"))
    with torch.device("meta"):
        model = SSN(zdim0=10, n0=32, resolution_levels=7, nlabels=2)
    have = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    assert have == [(n, shape) for n, shape, _ in PR.param_spec(cfg)]
    assert have == [(n, shape) for n, shape in R.param_spec(cfg)]
    assert sum(p.numel() for p in model.parameters()) == 10_320_568
    assert model.latent_shapes(8) == ((8, 128, 128, 2), (8, 10))
    assert model.likelihood.cov_factor.conv.weight.shape == (20, 32, 1, 1)


def test_the_family_s_spans():
    """Under a profiler: the step's `train_step.ssn_loss` inside
    `train_step.forward`, the sampler's `sample.decode.lowrank` inside
    `sample.decode` beside `sample.encode`."""
    from phiseg_tpu_torch.utils.profiling import SPANS

    cfg = _cfg(image_size=(32, 32, 1))
    state = create_train_state(cfg, device="cpu", seed=0)
    step, sample = make_train_step(cfg), make_sample_fn(state.model, 3)
    g = torch.Generator().manual_seed(0)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, *_batch(16, size=32), g)
        sample(_batch(17, b=2, size=32)[0], g)
    found = {(r.name, r.parent.name if r.parent else None) for r in SPANS.records()}
    assert found >= {("train_step.ssn_loss", "train_step.forward"),
                     ("sample.decode.lowrank", "sample.decode"), ("sample.encode", None)}


class _SameBatch:
    def __init__(self, x, s):
        self.x, self.s = x, s

    def next_batch(self, batch_size):
        return self.x[:batch_size].copy(), self.s[:batch_size].copy()


def test_trainer_validation_checkpoint_resume_and_test_quantitative(tmp_path):
    """ssn_synth at the tiny size through the Trainer: 5 steps in one run
    against 3 steps, a checkpoint and a resumed run to 5, bit for bit, with
    validations at steps 2 and 4 and SSN's summaries in metrics.jsonl; then
    test_quantitative's 100-sample scores of the log dir."""
    cfg = _cfg(experiment_name="ssn_tiny", synth_n_train=8, synth_n_val=4, synth_n_test=4,
               validation_frequency=2, validation_samples=3, validation_elbo_samples=2,
               tensorboard_update_frequency=1, num_validation_images=4,
               do_image_summaries=False)
    data = get_dataset(cfg)
    data.train = _SameBatch(*data.train.next_batch(4))  # the batches a resumed run takes alike
    whole = Trainer(cfg, log_dir=str(tmp_path / "whole"), device="cpu")
    whole.train(data, num_iter=5)
    first = Trainer(cfg, log_dir=str(tmp_path / "split"), device="cpu")
    first.train(data, num_iter=3)
    second = Trainer(cfg, log_dir=str(tmp_path / "split"), device="cpu")
    assert second.init_step == 3
    second.train(data, num_iter=5)
    for k, v in whole.state.model.state_dict().items():
        assert torch.equal(v, second.state.model.state_dict()[k]), k
    assert torch.equal(whole.generator.get_state(), second.generator.get_state())

    log_dir = str(tmp_path / "whole")
    lines = [json.loads(line) for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    batch = [r for r in lines if "batch_ssn_loglik" in r]
    assert [r["step"] for r in batch] == [0, 1, 2, 3, 4]
    assert all(np.isfinite(r["batch_total_loss"]) and r["batch_ssn_cov_diag_mean"] > 2 * EPS
               and r["batch_total_loss"] == pytest.approx(-r["batch_ssn_loglik"]) for r in batch)
    assert [r["step"] for r in lines if "validation_GED" in r] == [2, 4]
    assert any("val_batch_ssn_loglik" in r for r in lines)
    assert any(f.startswith("model") and f.endswith(".pt") for f in os.listdir(log_dir))
    quant_main([log_dir, "--samples", "100", "--batch", "2", "--device", "cpu"])
    npz = [f for f in os.listdir(log_dir) if f.startswith("ged100_")]
    ged = np.load(os.path.join(log_dir, npz[0]))["arr_0"]
    assert ged.shape == (4,) and np.isfinite(ged).all()
