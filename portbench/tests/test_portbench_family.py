"""A model family that no file of the harness knows, added from files alone:
a stand-in reference module (`reference/standin.py`) and a configuration
that names it, written into a bench directory with the cells' entries, and
a stand-in program that the test registers in place of the port's model and
train step. Its train, eval and sample cells run through run.run_cell on
the CPU with `correct` true. The stand-in's train step draws a uniform from
the step's generator (a Gumbel top-k of the pixels in its loss) and carries
a state from step to step (a multiplier of its constraint, raised by the
constraint's moving average, as GECO's is): a reference that leaves out
either one fails the check. Also: which module the harness resolves, the
configuration's own tiny overrides, and that the harness's files reach the
model families' reference only through the configuration."""

import ast
import json
import os

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from portbench.tests.tiny import FAMILY_TINY, PKG, SHRINK, tiny_experiment, write_bench

torch.set_num_threads(1)
SEED = 2 ** 31 + 17

# the stand-in family's numbers, shared by its program and its reference
CONST = {"WIDTH": 8, "KEEP": 0.25, "KAPPA": 0.1, "DECAY": 0.5, "RATE": 1.0}

REFERENCE = '''
"""Plain reference of the stand-in family: a 3x3 conv encoder, a Gaussian
latent map from 1x1 heads, a 3x3 decoder of the features and the latent;
trained on the cross-entropy of a share KEEP of the pixels, picked by a
Gumbel top-k of uniform draws, minus KAPPA, weighted by a multiplier that
the train state carries, plus the latent's KL."""

import math

import torch
import torch.nn.functional as F

from portbench.reference import Adam


def param_spec(cfg):
    cin, nl, z = cfg["image_size"][2], cfg["nlabels"], cfg["zdim0"]
    return [("enc.weight", (WIDTH, cin, 3, 3), "conv"), ("enc.bias", (WIDTH,), "zero"),
            ("mu.weight", (z, WIDTH, 1, 1), "head"), ("mu.bias", (z,), "zero"),
            ("sigma.weight", (z, WIDTH, 1, 1), "head"), ("sigma.bias", (z,), "zero"),
            ("dec.weight", (nl, WIDTH + z, 3, 3), "conv"), ("dec.bias", (nl,), "zero")]


def init_std(shape, kind):
    std = math.sqrt(2.0 / math.prod(shape[1:]))
    return std / 2 if kind == "head" else std


def latent_shapes(cfg, batch):
    return [(batch, *cfg["image_size"][:2], cfg["zdim0"])]


def trainable(spec):
    return [n for n, _, _ in spec]


def lr_at(cfg, step):
    return [v for k, v in sorted((int(k), v) for k, v in cfg["lr_schedule"].items()) if k <= step][-1]


def heads(p, x):
    f = F.relu(F.conv2d(x, p["enc.weight"], p["enc.bias"], padding=1))
    return f, F.conv2d(f, p["mu.weight"], p["mu.bias"]), F.softplus(F.conv2d(f, p["sigma.weight"], p["sigma.bias"]))


def decode(p, f, z):
    return F.conv2d(torch.cat([f, z], 1), p["dec.weight"], p["dec.bias"], padding=1)


def keep(u):
    g = -torch.log(-torch.log(u))
    idx = torch.topk(g.flatten(), max(1, int(KEEP * u.numel()))).indices
    return torch.zeros(u.numel(), device=u.device).index_fill_(0, idx, 1.0).view(u.shape)


def sample_probs(cfg, params, x, eps, prec="f32"):
    S, b = eps[0].shape[:2]
    f, mu, sigma = heads(params, x.permute(0, 3, 1, 2).float())
    e = eps[0].float().reshape(S * b, *eps[0].shape[2:]).permute(0, 3, 1, 2)
    f, mu, sigma = (t.repeat(S, 1, 1, 1) for t in (f, mu, sigma))
    probs = torch.softmax(decode(params, f, mu + sigma * e), dim=1)
    return probs.reshape(S, b, *probs.shape[1:]).permute(0, 1, 3, 4, 2)


def grad_step(cfg, params, x, s, draw, prec="f32", generator=None, state=None):
    names = trainable(param_spec(cfg))
    leaves = {n: params[n].detach().requires_grad_(True) for n in names}
    with torch.enable_grad():
        f, mu, sigma = heads(leaves, x.permute(0, 3, 1, 2).float())
        logits = decode(leaves, f, mu + sigma * draw(tuple(mu.shape)))
        ce = F.cross_entropy(logits, s.long(), reduction="none")
        u = torch.rand(ce.shape, generator=generator if REPLAY_UNIFORM else None, device=ce.device)
        k = keep(u)
        recon = (ce * k).sum() / k.sum()
        kl = (0.5 * (mu.square() + sigma.square() - 1.0) - torch.log(sigma)).mean()
        lam = state["lam"] if REPLAY_STATE else 1.0
        loss = lam * (recon - KAPPA) + kl
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
    return loss.detach(), dict(zip(names, grads)), dict(state, constraint=recon.detach() - KAPPA)


def train_state(cfg, params):
    return {"lam": 1.0, "ma": None}


class _Step:
    def __init__(self, cfg, params, names):
        self.cfg, self.adam = cfg, Adam(params, names)

    def step(self, params, grads, i, state):
        self.adam.step(params, grads, lr_at(self.cfg, i))
        c = float(state["constraint"])
        ma = c if state["ma"] is None else DECAY * state["ma"] + (1 - DECAY) * c
        return {"lam": max(0.0, state["lam"] + RATE * ma), "ma": ma}


def optimizer(cfg, params, names):
    return _Step(cfg, params, names)
'''


# ---------------------------------------------------------------------------
# the stand-in program, registered in place of the port's build_model and
# make_train_step for the family "standin"; the port's samplers, eval and
# metrics run it through the SegVAE sampling methods it has


class StandIn(nn.Module):
    has_latents = True

    def __init__(self, cfg):
        super().__init__()
        cin, nl, z, w = cfg.image_size[2], cfg.nlabels, cfg.zdim0, CONST["WIDTH"]
        self.enc = nn.Conv2d(cin, w, 3, padding=1)
        self.mu = nn.Conv2d(w, z, 1)
        self.sigma = nn.Conv2d(w, z, 1)
        self.dec = nn.Conv2d(w + z, nl, 3, padding=1)
        self.dtype, self.hw, self.zdim = cfg.dtype, cfg.image_hw, z

    def heads(self, x):
        f = F.relu(self.enc(x.permute(0, 3, 1, 2).to(self.dtype)))
        return f, self.mu(f), F.softplus(self.sigma(f))

    def latent_shapes(self, batch):
        return ((batch, *self.hw, self.zdim),)

    def sample_cache(self, x):
        return self.heads(x)

    def repeat_cache(self, cache, n):
        return tuple(t.repeat(n, 1, 1, 1) for t in cache)

    def decode_sample(self, cache, eps=None, generator=None):
        f, mu, sigma = cache
        z = mu + sigma * eps[0].permute(0, 3, 1, 2)
        return (self.dec(torch.cat([f, z], 1)).permute(0, 2, 3, 1).float(),)


def _keep(u):
    g = -torch.log(-torch.log(u))
    idx = torch.topk(g.flatten(), max(1, int(CONST["KEEP"] * u.numel()))).indices
    return torch.zeros(u.numel(), device=u.device).index_fill_(0, idx, 1.0).view(u.shape)


def _standin_step(cfg, augment_fn):
    from phiseg_tpu_torch.engine.train import lr_schedule_from_dict

    lr_fn = lr_schedule_from_dict(cfg.lr_schedule)
    geco = {"lam": 1.0, "ma": None}

    def step(state, x, s, generator=None, eps=None):
        if augment_fn is not None:
            x, s = augment_fn(x, s, generator)
        model, opt = state.model, state.optimizer
        f, mu, sigma = model.heads(x)
        noise = torch.randn(mu.shape, generator=generator, device=x.device, dtype=model.dtype)
        logits = model.dec(torch.cat([f, mu + sigma * noise], 1)).float()
        ce = F.cross_entropy(logits, s.long(), reduction="none")
        k = _keep(torch.rand(ce.shape, generator=generator, device=x.device))
        recon = (ce * k).sum() / k.sum()
        kl = (0.5 * (mu.square() + sigma.square() - 1.0) - torch.log(sigma)).mean()
        loss = geco["lam"] * (recon - CONST["KAPPA"]) + kl
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = lr_fn(state.step)
        opt.step()
        c = float(recon.detach()) - CONST["KAPPA"]
        ma = c if geco["ma"] is None else CONST["DECAY"] * geco["ma"] + (1 - CONST["DECAY"]) * c
        geco.update(lam=max(0.0, geco["lam"] + CONST["RATE"] * ma), ma=ma)
        state.step += 1
        return {"total_loss": loss.detach()}

    return step


@pytest.fixture
def standin_program(monkeypatch):
    import phiseg_tpu_torch.engine.train as T

    plain_build, plain_step = T.build_model, T.make_train_step

    def build_model(cfg, device="cuda", seed=None):
        if cfg.model_family != "standin":
            return plain_build(cfg, device, seed)
        return StandIn(cfg).to(device)

    def make_train_step(cfg, augment_fn=None, **kw):
        if cfg.model_family != "standin":
            return plain_step(cfg, augment_fn, **kw)
        return _standin_step(cfg, augment_fn)

    monkeypatch.setattr(T, "build_model", build_model)
    monkeypatch.setattr(T, "make_train_step", make_train_step)


# the stand-in's cells: the kind of each, the committed cell whose traffic
# and metrics it takes, and its limits (float32 on both sides)
CELLS = {
    "train": ("phiseg_7_5-train", {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-3}),
    "eval_b8": ("phiseg_7_5-eval_b8", {"prob_gap": 1e-5, "ged_gap": 3e-5, "sncc_gap": 1e-4}),
    "sample_b1": ("phiseg_7_5-sample_b1", {"prob_gap": 1e-5}),
}


def _add_family(d, name, **replay):
    """Files and entries of a family `name`, whose reference replays the
    state and the uniform draws unless `replay` says otherwise."""
    os.makedirs(os.path.join(d, "reference"), exist_ok=True)
    head = "".join(f"{k} = {v!r}\n" for k, v in CONST.items())
    head += "".join(f"REPLAY_{k.upper()} = {replay.get(k, True)!r}\n" for k in ("state", "uniform"))
    with open(os.path.join(d, "reference", f"{name}.py"), "w") as f:
        f.write(head + REFERENCE)
    with open(os.path.join(d, "configs", "probunet.json")) as f:
        exp = json.load(f)["experiment"]
    exp.update(model_family="standin", zdim0=2)
    with open(os.path.join(d, "configs", f"{name}.json"), "w") as f:
        json.dump({"reference": name, "experiment": exp}, f)
    with open(os.path.join(d, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": name, "source": "a test", "file": f"configs/{name}.json",
                             "reduced": [], "why": "a family the harness does not know"})
    for kind, (like, limits) in CELLS.items():
        cell = f"{name}-{kind}"
        bench["workloads"].append({"name": cell, "config": name, "chips": 1, "why": "a test",
                                   "traffic": next(w["traffic"] for w in bench["workloads"]
                                                   if w["name"] == like)})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
        with open(os.path.join(d, "limits", f"{cell}.json"), "w") as f:
            json.dump(limits, f)
    with open(os.path.join(d, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


@pytest.fixture(scope="module")
def family_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("family"))
    write_bench(d)
    _add_family(d, "standin")
    _add_family(d, "standin_nostate", state=False)
    _add_family(d, "standin_nouniform", uniform=False)
    return d


def _run(cell, d):
    from portbench import run

    return run.run_cell(cell, SEED, 0.3, False, device="cpu", root=d, pkg=d)


@pytest.mark.parametrize("kind", list(CELLS))
def test_a_new_family_from_files_alone(kind, family_dir, standin_program):
    result, checks = _run(f"standin-{kind}", family_dir)
    assert result["correct"] and result["attempted"] > 0, checks
    assert [k for k, _, _ in checks] == list(CELLS[kind][1])
    assert "setup_s" in result["metrics"]


@pytest.mark.parametrize("fault,fails", [("nostate", "loss_gap"), ("nouniform", "loss_gap")])
def test_a_replay_without_the_family_s_state_or_draws_fails(fault, fails, family_dir,
                                                            standin_program):
    result, checks = _run(f"standin_{fault}-train", family_dir)
    assert not result["correct"]
    assert fails in [k for k, value, limit in checks if not value <= limit]


def test_the_new_family_counts_its_own_flops(family_dir):
    from portbench import counts
    from portbench.cells import Bench

    bench = Bench(family_dir, family_dir)
    config = bench.config({"config": "standin"})
    ref = bench.reference(config)
    cfg = config["experiment"]
    h, w = cfg["image_size"][:2]
    conv = 2 * h * w * CONST["WIDTH"] * 9  # the encoder's 3x3 conv of one channel, one image
    assert counts.unit_flops(ref, cfg, {"kind": "sample", "batch": 1, "samples": 2}) > 2 * conv
    assert counts.unit_flops(ref, cfg, {"kind": "train", "batch": 4}) > 4 * conv


def test_the_reference_a_configuration_names(family_dir, tmp_path):
    from portbench.cells import Bench
    from portbench.reference import model

    bench = Bench(family_dir, family_dir)
    default = bench.reference({"experiment": {}})
    assert default.__file__ == model.__file__
    assert bench.reference({"reference": "model"}) is default
    assert bench.reference({"reference": "standin"}).WIDTH == CONST["WIDTH"]
    with pytest.raises(ValueError):
        bench.reference({"reference": "../model"})
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "half.py").write_text("def param_spec(cfg):\n    return []\n")
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump({}, f)
    with pytest.raises(AttributeError, match="latent_shapes"):
        Bench(str(tmp_path), str(tmp_path)).reference({"reference": "half"})


def test_a_configuration_s_own_tiny_overrides():
    with open(os.path.join(PKG, "configs", "phiseg_7_5.json")) as f:
        doc = json.load(f)
    assert tiny_experiment(doc)["latent_levels"] == FAMILY_TINY["phiseg"]["latent_levels"]
    doc["tiny"] = {"resolution_levels": 4, "latent_levels": 2}
    exp = tiny_experiment(doc, "bfloat16")
    assert (exp["resolution_levels"], exp["latent_levels"], exp["n0"], exp["compute_dtype"]) == \
        (4, 2, SHRINK["n0"], "bfloat16")


@pytest.mark.parametrize("name", ["loops.py", "counts.py", "weights.py", "control.py", "run.py"])
def test_the_harness_reaches_the_model_reference_only_through_the_configuration(name):
    tree = ast.parse(open(os.path.join(PKG, name)).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            assert not any(a.name.startswith("portbench.reference.model") for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert not (node.module or "").startswith("portbench.reference.model")
            if node.module == "portbench.reference":
                assert "model" not in [a.name for a in node.names]
