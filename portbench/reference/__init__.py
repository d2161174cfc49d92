"""The plain float32 references that decide `correct`: the model families,
the augmentation, the losses, Adam and the metrics in plain PyTorch, with no
import of the program under test.

A configuration's file names its model reference by the key "reference":
the module `reference/<name>.py`, found under the bench's own directory
first and then under this package (cells.Bench.reference), "model" where
the key is absent. A new model family is a new module and a configuration
that names it; no file of the harness changes. What such a module provides:

  param_spec(cfg)            [(name, shape, kind)] of every parameter and
                             buffer, by the program's state-dict names; a
                             kind "one" or "zero" is that constant, any
                             other kind one normal draw (weights.py)
  init_std(shape, kind)      the standard deviation of a drawn kind
  latent_shapes(cfg, batch)  the sampler's noise shapes, one a latent level,
                             finest first, channels last, as the program
                             draws them (normal, in the compute dtype, each
                             with a leading number of samples)
  sample_probs(cfg, params, x, eps, prec="f32")
                             the sampler's probabilities (S, B, H, W, C) of
                             x (B, H, W, C) under that noise, in eval mode
  trainable(spec)            the names that training moves
  lr_at(cfg, step)           the learning rate at a step
  grad_step(cfg, params, x, s, draw, prec="f32", generator=None, state=None)
                             one training forward and backward of the
                             augmented batch: (loss, gradients by name, the
                             train state after it). draw(shape) is the
                             program's next normal draw; `generator` is the
                             step's replayed generator itself, for any other
                             draw (uniform, Gumbel) in the program's order,
                             and None where values do not matter (the FLOP
                             count on meta tensors); `state` is the family's
                             train state before the step
  train_state(cfg, params)   the train state before the first step, carried
                             through the replay (None where a family has
                             none)
  optimizer(cfg, params, names)
                             an object whose step(params, grads, step,
                             state) updates the named parameters in place
                             and returns the train state (AdamStep where a
                             family trains with the program's Adam alone)

`prec` is the precision of the convolutions: "f32", "bf16" or "fp8" (the
control). The harness draws the weights, replays the noise and the train
steps, and counts the FLOPs through these functions alone.

Not covered: the sampler's noise is replayed as one normal draw a latent
level; the train check takes the program's first gradient from its
torch.optim Adam's first moment (exp_avg / 0.1) over the model's
named_parameters(), so a family whose program steps another optimizer, or
trains a quantity held outside them (a multiplier as a parameter), needs
that reading changed in loops.py first.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Sequence

import torch

REQUIRED = ("param_spec", "init_std", "latent_shapes", "sample_probs", "trainable", "lr_at",
            "grad_step", "train_state", "optimizer")


class Adam:
    """Adam (Kingma and Ba) with beta 0.9 / 0.999 and eps 1e-8, the source's
    tf.train.AdamOptimizer defaults, eps added to the bias-corrected root."""

    def __init__(self, params: Dict[str, torch.Tensor], names: Sequence[str]):
        self.names = list(names)
        self.m = {n: torch.zeros_like(params[n]) for n in self.names}
        self.v = {n: torch.zeros_like(params[n]) for n in self.names}
        self.t = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
             lr: float) -> None:
        self.t += 1
        b1, b2, eps = 0.9, 0.999, 1e-8
        for n in self.names:
            g = grads[n]
            self.m[n].mul_(b1).add_(g, alpha=1 - b1)
            self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[n] / (1 - b2 ** self.t)).sqrt() + eps
            params[n].sub_(lr * (self.m[n] / (1 - b1 ** self.t)) / denom)


class AdamStep:
    """The optimizer step of a family that trains with Adam alone: Adam over
    `names` at lr(step); the train state passes through."""

    def __init__(self, lr: Callable[[int], float], params: Dict[str, torch.Tensor],
                 names: Sequence[str]):
        self.lr = lr
        self.adam = Adam(params, names)

    def step(self, params, grads, step: int, state):
        self.adam.step(params, grads, self.lr(step))
        return state
