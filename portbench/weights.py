"""The parameters of a cell, made from its seed on the device in a few large
calls: one normal draw for every parameter of a drawn kind, scaled per
parameter by the reference's init_std (the model families': He normal, std
sqrt(2 / fan_in), a Gaussian head's at a quarter of it, see
reference.model.HEAD_SCALE); the kinds "one" and "zero" (the model
families' conv biases, batch-norm shifts and scales, running statistics)
are those constants."""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch

CONSTANT = {"one": torch.ones, "zero": torch.zeros}


def make_weights(spec, seed: int, device,
                 init_std: Callable[[Sequence[int], str], float]) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} for `spec` (a reference's param_spec), the drawn
    kinds scaled by `init_std` (the same reference's)."""
    g = torch.Generator(device=device).manual_seed(seed)
    drawn = [(n, shape, kind) for n, shape, kind in spec if kind not in CONSTANT]
    sizes = [math.prod(shape) for _, shape, _ in drawn]
    std = torch.tensor([init_std(shape, kind) for _, shape, kind in drawn], device=device)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    flat.mul_(std.repeat_interleave(torch.tensor(sizes, device=device)))
    out = {n: t.view(shape) for t, (n, shape, _) in zip(flat.split(sizes), drawn)}
    for n, shape, kind in spec:
        if kind in CONSTANT:
            out[n] = CONSTANT[kind](shape, device=device)
    return out
