"""A train step captured in one CUDA graph and replayed.

The host's dispatch of a PHiSeg train step, about 3,400 launches of the
augmentation, one-hot, forward, objective, backward and the optimiser's
update, takes several times the card's time for them. `StepGraph` captures
one whole step in a torch.cuda.CUDAGraph and then replays it: each call
copies the new batch into the graph's static inputs, replays, and copies the
losses out, so the card runs the same kernels in the same order at the same
precision while the host issues one launch.

The graph belongs to what the step can observe (`_key`): the batch's shapes,
dtypes and device, the train state (its model, its optimiser and the
optimiser's state dict), the generator, the rate (baked into the graph:
the schedule is piecewise constant, so a run captures a handful of times)
and the TF32 switches that pick the kernels. When one of them changes, the
step drops the old graph and captures again. A capture

  1. warms up on a throwaway copy of the model and optimiser, with a copy of
     the generator, on the capture's stream: cuDNN's and cuBLAS's handles
     and plans, K1's ticket and the kernel libraries are made there, and the
     real state and generator are left as they were;
  2. makes the real optimiser's state on the card as its first step would
     (Adam's step 0 and zero moments, SGD's zero momentum, which its first
     step turns into the gradient as the eager step's copy does), for the
     parameters that the warm-up gave a gradient; state that a checkpoint or
     an eager step made is kept, Adam's step counts moved to the card; and
     sets Adam's `capturable` and `fused` (`graph_settings`) for the warm-up and
     the capture alone, so the optimiser and its checkpoints stay as the
     caller made them;
  3. sets the gradients to None, so that the backward makes them in the
     graph's memory pool, and captures with the caller's generator
     registered: each replay draws from the generator's state at the call
     and leaves it where the eager step would, bit for bit.

The kernels' launch counters (`fused_residual_ce.LAUNCHES`,
`upsample_bilinear2x.LAUNCHES`, `bn_act_eval.LAUNCHES`) count host calls:
the warm-up's and the capture's are taken back, and each replay adds the
capture's, so they count the kernels run. `COUNTS` counts the process's
captures, replays and eager steps. Spans: `train_step.capture` around a
capture (its warm-up included), `train_step.replay` around a replay; the
step's phase spans fire only in a capture.
"""

from __future__ import annotations

import copy
import dataclasses
import warnings
from typing import Callable, Dict, List, Optional

import torch

from phiseg_tpu_torch.ops import bn_act_eval, fused_residual_ce, upsample_bilinear2x
from phiseg_tpu_torch.utils.profiling import span

WARMUP_STEPS = 2  # eager steps of the throwaway copy before a capture
COUNTS: Dict[str, int] = {"captures": 0, "replays": 0, "eager": 0}
_LAUNCH_COUNTERS = (fused_residual_ce.LAUNCHES, upsample_bilinear2x.LAUNCHES,
                    bn_act_eval.LAUNCHES)
# the optimisers whose update a capture holds: their state is made before it
CAPTURED_OPTIMIZERS = (torch.optim.Adam, torch.optim.SGD)


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def graph_settings(optimizer: torch.optim.Optimizer) -> Dict[str, bool]:
    """The settings a capture gives each of the optimiser's groups: Adam's
    step counts on the card (`capturable`) and one fused kernel for its
    update (`fused`: the foreach update made capturable divides by each
    tensor's bias corrections one tensor at a time, two more launches a
    parameter tensor); none for SGD."""
    return {"capturable": True, "fused": True} if type(optimizer) is torch.optim.Adam else {}


def on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def capturable(x: torch.Tensor, generator: Optional[torch.Generator], eps, mesh,
               optimizer: torch.optim.Optimizer) -> bool:
    """Whether a step on these runs as a graph: a batch on the card, the
    caller's generator on the card (the draws a replay makes), no injected
    noise, no mesh (the gradients' all-reduce between backward and the
    optimiser), and an optimiser whose state a capture can make first."""
    return (mesh is None and eps is None and generator is not None and on_card(x)
            and generator.device.type == x.device.type
            and type(optimizer) in CAPTURED_OPTIMIZERS)


class CudaGraph:
    """A torch.cuda.CUDAGraph and the side stream it is warmed up and
    captured on."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self.stream = torch.cuda.Stream(device)

    def warm_up(self, fn: Callable[[], object]) -> None:
        """Run `fn` eagerly on the capture's stream."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            fn()
        current.wait_stream(self.stream)

    def capture(self, fn: Callable[[], object],
                generator: Optional[torch.Generator] = None) -> object:
        """Capture `fn`'s work, drawing from `generator` (if any) at each
        replay; its result is the graph's static output. Other threads (a
        prefetch thread) may go on using the card meanwhile."""
        if generator is not None:
            self.graph.register_generator_state(generator)
        with torch.cuda.graph(self.graph, stream=self.stream, capture_error_mode="thread_local"):
            return fn()

    def replay(self) -> None:
        self.graph.replay()


def _launches() -> List[Dict[str, int]]:
    return [dict(c) for c in _LAUNCH_COUNTERS]


def _set_launches(counts: List[Dict[str, int]]) -> None:
    for c, v in zip(_LAUNCH_COUNTERS, counts):
        c.update(v)


def _key(state, x: torch.Tensor, s: torch.Tensor, generator: torch.Generator, lr: float):
    """(objects compared by identity, values compared by equality)."""
    return ((state, state.model, state.optimizer, state.optimizer.state, generator),
            (x.shape, x.dtype, s.shape, s.dtype, x.device, lr,
             torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))


def _same(a, b) -> bool:
    return (b is not None and all(p is q for p, q in zip(a[0], b[0])) and a[1] == b[1])


def _params(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    return [p for group in optimizer.param_groups for p in group["params"]]


def _make_state(optimizer: torch.optim.Optimizer, made: torch.optim.Optimizer) -> None:
    """Give `optimizer` the state that `made`, the warm-up copy's optimiser
    over the same parameters in the same order, made at its first step, as
    zeros on the card: the parameters that got a gradient, with the keys
    and layouts of their state. A parameter's existing state is kept, its
    tensors moved to the parameter's device."""
    for p, q in zip(_params(optimizer), _params(made)):
        if q not in made.state:
            continue
        own = optimizer.state[p]
        if own:
            for k, v in own.items():
                if torch.is_tensor(v):
                    own[k] = v.to(p.device)
        else:
            own.update({k: torch.zeros_like(v) if torch.is_tensor(v) else v
                        for k, v in made.state[q].items()})


class StepGraph:
    """One train step, `one_step(state, x, s, generator, eps, lr) -> loss
    dict`, captured and replayed; call it as `one_step` without `eps`."""

    def __init__(self, one_step: Callable[..., Dict[str, torch.Tensor]]):
        self.one_step = one_step
        self.key = None
        self.graph: Optional[CudaGraph] = None
        self.names: List[str] = []  # the loss dict's keys, in the static output's order

    def __call__(self, state, x: torch.Tensor, s: torch.Tensor, generator: torch.Generator,
                 lr: float) -> Dict[str, torch.Tensor]:
        key = _key(state, x, s, generator, lr)
        if not _same(key, self.key):
            with span("train_step.capture"):
                self._capture(state, x, s, generator, lr)
            self.key = key
            COUNTS["captures"] += 1
        with span("train_step.replay"):
            self.x.copy_(x)
            self.s.copy_(s)
            self.graph.replay()
            out = self.out.clone()
        for c, d in zip(_LAUNCH_COUNTERS, self.launches):
            for k, v in d.items():
                c[k] += v
        COUNTS["replays"] += 1
        return dict(zip(self.names, out.unbind(0)))

    def _drop(self) -> None:
        """Free the graph, its pool and the gradients made in it."""
        if self.key is not None:
            self.key[0][2].zero_grad(set_to_none=True)
        self.key = self.graph = self.x = self.s = self.out = None

    def _capture(self, state, x, s, generator, lr) -> None:
        self._drop()
        before = _launches()
        model, opt = state.model, state.optimizer
        opt.zero_grad(set_to_none=True)  # the backward makes them in the graph's pool
        graph = CudaGraph(x.device)
        with warnings.catch_warnings():
            # the copy's capturable Adam steps uncaptured on purpose
            warnings.filterwarnings("ignore", message=".*capturable=True.*")
            model_c, opt_c = copy.deepcopy((model, opt))
            opt_c.state.clear()
            for group in opt_c.param_groups:
                group.update(graph_settings(opt_c))
            gen_c = torch.Generator(device=generator.device)
            gen_c.set_state(generator.get_state())
            state_c = dataclasses.replace(state, model=model_c, optimizer=opt_c)

            def warm_up():
                for _ in range(WARMUP_STEPS):
                    self.one_step(state_c, x, s, gen_c, None, lr)
            graph.warm_up(warm_up)
        _make_state(opt, opt_c)
        del model_c, opt_c, state_c
        warmed = _launches()
        self.x, self.s = x.clone(), s.clone()

        def step():
            losses = self.one_step(state, self.x, self.s, generator, None, lr)
            self.names = list(losses)
            return torch.stack([v.detach() for v in losses.values()])

        settings = graph_settings(opt)
        callers = [{k: g[k] for k in settings} for g in opt.param_groups]
        for g in opt.param_groups:
            g.update(settings)
        try:
            self.out = graph.capture(step, generator)
        finally:
            for g, was in zip(opt.param_groups, callers):
                g.update(was)
        self.launches = [{k: c[k] - w.get(k, 0) for k in c}
                         for c, w in zip(_launches(), warmed)]
        _set_launches(before)
        self.graph = graph
