"""A function of tensors captured in one CUDA graph an input signature and
replayed: the host-bound parts of a sampler's eval.

SSN's eval (models/ssn.py) runs its network once a call, on the B images of
the batch, draws all S samples from the result with a few matmuls and adds,
and then scores them. At B = 8 and 128x128 the network, the deterministic
U-Net's 42 batch-normed convolutions with their BN + ReLU epilogues, its x2
resizes, pools and concats and the three heads, is some 120 operations, and
the metrics stage (GED^2's pairwise IoUs and S_NCC) some 160 more, each
small: their dispatch takes longer than the card's work for them, so the
eval waits on the host and runs at the host's pace. A model whose
`replay_sampler` is set has both replayed from graphs (engine/train.py
`make_sample_fn`, engine/validation.py `make_quant_eval_fn`), so the host
issues one launch for each.

`ReplayGraph(fn)` calls `fn(*args)` eagerly unless every argument is a
tensor on one card and autograd is off; then it replays the graph of the
arguments' shapes, strides, dtypes and device, captured at the first such
call: the arguments are copied into the graph's static inputs, the graph is
replayed, and copies of its outputs are returned, so a caller may keep them
as it keeps an eager call's. A capture warms up twice on its own stream
(cuDNN's plans, the kernels' libraries) and then captures. Nothing that
`fn` reads besides its arguments may change by anything but an in-place
write: `reads` names such tensors (a model's parameters and buffers), and
the graphs are dropped and captured again when one of them has moved to
new storage, or when a TF32 switch that picks the kernels has changed.
`fn` must not draw random numbers or synchronise with the host.

Launch counters are kept as `step_graph` keeps them: a replay adds the
capture's launches, so they count the kernels run. `COUNTS` counts the
process's captures and replays.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch

from phiseg_tpu_torch.engine.step_graph import CudaGraph, _LAUNCH_COUNTERS, _launches, _set_launches

WARMUP_CALLS = 2  # eager calls on the capture's stream before a capture
COUNTS: Dict[str, int] = {"captures": 0, "replays": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


class ReplayGraph:
    """`fn(*args)`, replayed from a CUDA graph where it can be."""

    def __init__(self, fn: Callable, reads: Iterable[torch.Tensor] = ()):
        self.fn = fn
        self.reads = list(reads)
        self.seen = None  # the reads' storage addresses and the TF32 switches of the graphs
        # the arguments' signature -> (graph, static inputs, static outputs, launches)
        self.graphs: Dict[Tuple, tuple] = {}

    def __call__(self, *args):
        if (torch.is_grad_enabled() or not all(isinstance(a, torch.Tensor) for a in args)
                or len({a.device for a in args}) != 1 or not args[0].is_cuda):
            return self.fn(*args)
        seen = (tuple(t.data_ptr() for t in self.reads),
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        if seen != self.seen:
            self.graphs.clear()
            self.seen = seen
        key = tuple((tuple(a.shape), a.stride(), a.dtype, a.device) for a in args)
        if key not in self.graphs:
            self.graphs[key] = self._capture(args)
            COUNTS["captures"] += 1
        graph, inputs, outputs, launches = self.graphs[key]
        for static, a in zip(inputs, args):
            static.copy_(a)
        graph.replay()
        for c, d in zip(_LAUNCH_COUNTERS, launches):
            for k, v in d.items():
                c[k] += v
        COUNTS["replays"] += 1
        if isinstance(outputs, torch.Tensor):
            return outputs.clone()
        return tuple(t.clone() for t in outputs)

    def _capture(self, args) -> tuple:
        before = _launches()
        graph = CudaGraph(args[0].device)
        inputs = [a.clone() for a in args]

        def warm_up():
            for _ in range(WARMUP_CALLS):
                self.fn(*inputs)

        graph.warm_up(warm_up)
        warmed = _launches()
        outputs = graph.capture(lambda: self.fn(*inputs))
        launches = [{k: c[k] - w.get(k, 0) for k in c} for c, w in zip(_launches(), warmed)]
        _set_launches(before)
        return graph, inputs, outputs, launches
