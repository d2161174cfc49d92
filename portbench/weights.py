"""The parameters of a cell, made from its seed on the device in a few large
calls: one normal draw for every convolution kernel, scaled per kernel to He
normal (std sqrt(2 / fan_in); a Gaussian head's to a quarter of it, see
reference.model.HEAD_SCALE); conv biases, batch-norm shifts and running
means 0, batch-norm scales and running variances 1."""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.model import init_std


def make_weights(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} for `spec` (reference.model.param_spec)."""
    g = torch.Generator(device=device).manual_seed(seed)
    convs = [(n, shape, kind) for n, shape, kind in spec if kind in ("conv", "head")]
    sizes = [math.prod(shape) for _, shape, _ in convs]
    std = torch.tensor([init_std(shape, kind) for _, shape, kind in convs], device=device)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    flat.mul_(std.repeat_interleave(torch.tensor(sizes, device=device)))
    out = {n: t.view(shape) for t, (n, shape, _) in zip(flat.split(sizes), convs)}
    for n, shape, kind in spec:
        if kind == "one":
            out[n] = torch.ones(shape, device=device)
        elif kind == "zero":
            out[n] = torch.zeros(shape, device=device)
    return out
