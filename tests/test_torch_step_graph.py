"""The train step's dispatch between a CUDA graph and the eager step
(engine/step_graph.py), on the CPU: a stand-in for the graph does what a
capture and a replay do to the program's state, so the rule, the key, the
state a capture makes, the returned losses and the launch counters are
tested without a card. The graph's own numbers are held against the eager
step on the card by chip_smoke.py's graph phase."""

import dataclasses
import types

import pytest
import torch
import torch.optim.adam as torch_adam

from phiseg_tpu_torch.engine import step_graph
from phiseg_tpu_torch.engine.train import TrainState, create_train_state, make_train_step
from phiseg_tpu_torch.experiments import get_experiment
from phiseg_tpu_torch.ops import fused_residual_ce as frce
from phiseg_tpu_torch.ops import upsample_bilinear2x as up2
from phiseg_tpu_torch.utils import profiling

torch.set_num_threads(1)

TINY = dict(resolution_levels=5, n0=4, image_size=(32, 32, 1), batch_size=2,
            compute_dtype="float32", augmentation_options={})
FAMILIES = {"phiseg_7_5_synth": dict(latent_levels=3), "probunet_synth": {},
            "detunet_synth": {}, "hpunet_synth": dict(latent_levels=2)}
TOL = 1e-5  # f32: fused Adam's round-off against the foreach update's, over a few steps


class StandInGraph:
    """What a CUDA graph does to the program's state, on the CPU. A capture
    runs nothing: the stand-in runs the step once and puts back the model's
    and the optimiser's tensors and the generator (the gradients it made
    stay, as a capture's do; the launch counters keep the host calls, as a
    capture's Python makes them). A replay runs the captured work into the
    same static output and runs no Python: the counters are put back."""

    state = None  # the train state whose tensors a capture puts back
    made = 0

    def __init__(self, device):
        StandInGraph.made += 1

    def warm_up(self, fn):
        fn()

    def capture(self, fn, generator):
        state = StandInGraph.state
        tensors = [*state.model.state_dict().values(),
                   *(v for st in state.optimizer.state.values() for v in st.values()
                     if torch.is_tensor(v))]
        saved = [t.clone() for t in tensors]
        gen = generator.get_state()
        self.groups = [{k: v for k, v in g.items() if k != "params"}
                       for g in state.optimizer.param_groups]
        self.fn, self.out = fn, fn()
        with torch.no_grad():
            for t, v in zip(tensors, saved):
                t.copy_(v)
        generator.set_state(gen)
        return self.out

    def replay(self):
        """The captured work: the optimiser's settings of the capture."""
        groups = StandInGraph.state.optimizer.param_groups
        now = [{k: v for k, v in g.items() if k != "params"} for g in groups]
        counts = [dict(frce.LAUNCHES), dict(up2.LAUNCHES)]
        for g, captured in zip(groups, self.groups):
            g.update(captured)
        try:
            out = self.fn()
        finally:
            for g, was in zip(groups, now):
                g.update(was)
        frce.LAUNCHES.update(counts[0])
        up2.LAUNCHES.update(counts[1])
        self.out.copy_(out)


@pytest.fixture
def graphs(monkeypatch):
    """The stand-in in place of the card's graph, a CPU batch taken as on
    the card, and capturable Adam allowed on the CPU."""
    monkeypatch.setattr(step_graph, "CudaGraph", StandInGraph)
    monkeypatch.setattr(step_graph, "on_card", lambda t: True)
    supported = torch_adam._get_capturable_supported_devices
    monkeypatch.setattr(torch_adam, "_get_capturable_supported_devices",
                        lambda *a, **k: [*supported(*a, **k), "cpu"])
    step_graph.reset_counts()
    StandInGraph.made = 0
    yield
    StandInGraph.state = None


def _cfg(name="phiseg_7_5_synth", **kw):
    return get_experiment(name).replace(**TINY, **FAMILIES[name], **kw)


def _batch(cfg, seed=0, batch=None):
    g = torch.Generator().manual_seed(seed)
    b = batch or cfg.batch_size
    h, w, c = cfg.image_size
    return (torch.rand((b, h, w, c), generator=g),
            torch.randint(0, cfg.nlabels, (b, h, w), generator=g))


def _state(cfg):
    state = create_train_state(cfg, "cpu", seed=3)
    StandInGraph.state = state
    return state


def _run(cfg, steps, capture=True, batches=None, augment=None, graph_adam=False):
    """`steps` steps from one init and one generator seed: (state, losses of
    each step, generator states after each step). With `graph_adam`, Adam
    set as a capture sets it (step_graph.graph_settings)."""
    state = _state(cfg)
    if graph_adam:
        for group in state.optimizer.param_groups:
            group.update(step_graph.graph_settings(state.optimizer))
    step = make_train_step(cfg, augment, capture=capture)
    gen = torch.Generator().manual_seed(11)
    losses, gens = [], []
    for i in range(steps):
        x, s = (batches or [_batch(cfg, i)])[i % len(batches or [0])]
        losses.append({k: float(v) for k, v in step(state, x, s, gen).items()})
        gens.append(gen.get_state())
    return state, losses, gens


def _rel(a, b):
    return float((a - b).norm() / max(float(b.norm()), 1e-12))


@pytest.mark.parametrize("case,want", [("card", True), ("cpu", False), ("mesh", False),
                                       ("eps", False), ("no_generator", False),
                                       ("cpu_generator", False), ("rmsprop", False)])
def test_the_rule(case, want, monkeypatch):
    """A graph for a batch and a generator on the card, Adam or SGD, and
    nothing injected; eager otherwise."""
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    x = types.SimpleNamespace(device=cpu if case == "cpu" else card)
    monkeypatch.setattr(step_graph, "on_card", lambda t: t.device.type == "cuda")
    gen = types.SimpleNamespace(device=cpu if case in ("cpu", "cpu_generator") else card)
    opt = (torch.optim.RMSprop if case == "rmsprop" else torch.optim.Adam)(
        [torch.nn.Parameter(torch.zeros(2))])
    got = step_graph.capturable(x, None if case == "no_generator" else gen,
                                [x] if case == "eps" else None,
                                object() if case == "mesh" else None, opt)
    assert got is want


@pytest.mark.parametrize("case", ["cpu", "eps", "no_generator", "capture_off"])
def test_eager_where_a_graph_cannot_hold(case, graphs, monkeypatch):
    cfg = _cfg()
    if case == "cpu":
        monkeypatch.setattr(step_graph, "on_card", lambda t: t.is_cuda)
    state = _state(cfg)
    step = make_train_step(cfg, capture=case != "capture_off")
    gen = None if case == "no_generator" else torch.Generator().manual_seed(1)
    eps = None
    if case == "eps":
        eps = [torch.zeros(shape) for shape in state.model.latent_shapes(cfg.batch_size)]
    for i in range(2):
        x, s = _batch(cfg, i)
        step(state, x, s, gen, eps)
    assert step_graph.COUNTS == {"captures": 0, "replays": 0, "eager": 2}
    assert StandInGraph.made == 0 and state.step == 2


@pytest.mark.parametrize("family,optimizer", [*((f, "adam") for f in FAMILIES),
                                              ("phiseg_7_5_synth", "momentum")])
def test_replays_track_the_eager_step(family, optimizer, graphs):
    """One capture, then replays: the losses and parameters of the eager
    step with the graph's Adam settings, the generator where the eager step
    leaves it, bit for bit, and the optimiser's `capturable` and `fused` as
    the caller made them; SGD's momentum made zero at the capture, as its
    first step's copy of the gradient."""
    cfg = _cfg(family, optimizer=optimizer)
    state, losses, gens = _run(cfg, 4)
    assert step_graph.COUNTS == {"captures": 1, "replays": 4, "eager": 0}
    assert all(not g.get("capturable") and not g.get("fused")
               for g in state.optimizer.param_groups)
    step_graph.reset_counts()
    eager, eager_losses, eager_gens = _run(cfg, 4, capture=False, graph_adam=True)
    assert step_graph.COUNTS["eager"] == 4
    assert all(torch.equal(a, b) for a, b in zip(gens, eager_gens))
    for got, want in zip(losses, eager_losses):
        assert got.keys() == want.keys()
        assert all(got[k] == pytest.approx(want[k], rel=TOL, abs=TOL) for k in want)
    want = dict(eager.model.named_parameters())
    for n, p in state.model.named_parameters():
        assert _rel(p.detach(), want[n].detach()) < TOL, n


def test_a_replay_is_the_plain_adam_step(graphs):
    """From one state, a replay's update (fused Adam) and the eager step's
    (foreach Adam, its step counts on the host) part by round-off alone."""
    cfg = _cfg()
    graph, _, _ = _run(cfg, 1)
    eager, _, _ = _run(cfg, 1, capture=False)
    want = dict(eager.model.named_parameters())
    for n, p in graph.model.named_parameters():
        assert _rel(p.detach(), want[n].detach()) < 1e-6, n


def test_state_made_at_capture_is_the_first_steps(graphs):
    """The optimiser's state a capture makes: Adam's step 0 and zero moments
    for the parameters that got a gradient, none for the others; a
    parameter's state that exists is kept, moved to its device."""
    used, unused, kept = (torch.nn.Parameter(torch.ones(3)) for _ in range(3))
    opt = torch.optim.Adam([used, unused, kept])
    opt.state[kept] = {"step": torch.tensor(5.0), "exp_avg": torch.full((3,), 2.0),
                       "exp_avg_sq": torch.full((3,), 4.0)}
    made = torch.optim.Adam([torch.nn.Parameter(torch.ones(3)) for _ in range(3)],
                            capturable=True)
    for p in (made.param_groups[0]["params"][0], made.param_groups[0]["params"][2]):
        p.grad = torch.ones(3)
    made.step()
    step_graph._make_state(opt, made)
    assert set(opt.state) == {used, kept}
    st = opt.state[used]
    assert float(st["step"]) == 0.0 and not st["exp_avg"].any() and not st["exp_avg_sq"].any()
    assert float(opt.state[kept]["step"]) == 5.0 and float(opt.state[kept]["exp_avg"][0]) == 2.0


@pytest.mark.parametrize("change", ["shape", "generator", "state", "rate"])
def test_captures_again_when_the_key_changes(change, graphs):
    """A new batch shape, generator, train state or rate captures again, and
    the step after it computes with the new one: the rate's change shows in
    the parameters against the eager step's."""
    cfg = _cfg(lr_schedule={0: 1e-3, 2: 1e-2} if change == "rate" else {0: 1e-3})
    state = _state(cfg)
    step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(11)
    for i in range(4):
        if i == 2 and change == "generator":
            gen = torch.Generator().manual_seed(12)
        if i == 2 and change == "state":
            state = dataclasses.replace(state, optimizer=state.optimizer)
            StandInGraph.state = state
        x, s = _batch(cfg, i, batch=3 if change == "shape" and i >= 2 else None)
        step(state, x, s, gen)
    assert step_graph.COUNTS == {"captures": 2, "replays": 4, "eager": 0}
    if change == "rate":
        eager, _, _ = _run(cfg, 4, capture=False, graph_adam=True)
        want = dict(eager.model.named_parameters())
        gaps = [_rel(p.detach(), want[n].detach()) for n, p in state.model.named_parameters()]
        assert max(gaps) < TOL


def test_returned_losses_are_the_steps_own(graphs):
    """A replay writes the graph's static output anew; the losses a step
    returned keep their values through later steps."""
    cfg = _cfg()
    state = _state(cfg)
    step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(11)
    first = step(state, *_batch(cfg, 0), gen)
    kept = {k: float(v) for k, v in first.items()}
    second = step(state, *_batch(cfg, 1), gen)
    assert {k: float(v) for k, v in first.items()} == kept
    assert float(second["total_loss"]) != kept["total_loss"]


def test_launches_advance_by_the_captured_counts(graphs):
    """The kernels' counters count the kernels run: the warm-up's and the
    capture's host calls are taken back, each replay adds the capture's."""

    def augment(x, s, generator):
        frce.LAUNCHES["fused_residual_ce_fwd"] += 1
        up2.LAUNCHES["upsample2x_fwd"] += 2
        return x, s

    frce.reset_launch_counts()
    up2.reset_launch_counts()
    _run(_cfg(), 3, augment=augment)
    assert step_graph.COUNTS["replays"] == 3
    assert frce.LAUNCHES["fused_residual_ce_fwd"] == 3 and up2.LAUNCHES["upsample2x_fwd"] == 6
    assert frce.LAUNCHES["fused_residual_ce_bwd"] == 0 and up2.LAUNCHES["upsample2x_bwd"] == 0


def test_spans_of_capture_and_replay(graphs):
    """Under a profiler: every step is a `train_step` span; the first holds
    `train_step.capture` (and the phase spans of the step it captures) and
    a replay, the next only `train_step.replay`."""
    cfg = _cfg()
    state = _state(cfg)
    step = make_train_step(cfg)
    gen = torch.Generator().manual_seed(11)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(2):
            step(state, *_batch(cfg, i), gen)
    records = profiling.SPANS.records()
    names = [r.name for r in records]
    assert names.count("train_step") == 2 and names.count("train_step.replay") == 2
    assert names.count("train_step.capture") == 1
    # the phases of the warm-up's steps and of the captured one; a replay
    # runs none on the card (the stand-in's replay runs the Python again)
    in_capture = [r for r in records if r.name == "train_step.forward"
                  and r.parent.name == "train_step.capture"]
    assert len(in_capture) == step_graph.WARMUP_STEPS + 1
    assert isinstance(state, TrainState) and state.step == 2
