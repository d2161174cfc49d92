"""The operations and bytes of a cell's work, from shapes alone: FLOPs by
torch.utils.flop_counter over the configuration's own plain reference (a
module of portbench/reference/, cells.Bench.reference) on meta tensors (so a
kernel that replaces a library call in the program leaves the count where
it was), and the bytes of the fused residual cross-entropy kernels
(K1 forward, K2 backward) with each input read once and each output written
once."""

from __future__ import annotations

import functools
import json
from typing import Mapping, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import metrics as RM

META = torch.device("meta")


def _meta_params(ref, cfg: Mapping):
    return {n: torch.zeros(shape, device=META) for n, shape, _ in ref.param_spec(cfg)}


def _draw(shape):
    return torch.zeros(shape, device=META)


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def train_step_flops(ref, cfg: Mapping, batch: int) -> int:
    """Forward and backward of one training step at `batch` images, of the
    reference module `ref`, from its train state before the first step."""
    h, w, c = cfg["image_size"]
    x = torch.zeros((batch, h, w, c), device=META)
    s = torch.zeros((batch, h, w), dtype=torch.long, device=META)
    params = _meta_params(ref, cfg)
    state = ref.train_state(cfg, params)
    return _count(lambda: ref.grad_step(cfg, params, x, s, _draw, state=state))


def sample_flops(ref, cfg: Mapping, batch: int, samples: int, metrics: bool) -> int:
    """One sampler call of the reference module `ref`: encode `batch`
    images, decode `samples` draws of each; with `metrics`, GED^2 and S_NCC
    of every image against its annotators."""
    h, w, c = cfg["image_size"]
    params = _meta_params(ref, cfg)
    eps = [torch.zeros((samples, *shape), device=META) for shape in ref.latent_shapes(cfg, batch)]
    ann = torch.zeros((cfg["num_labels_per_subject"], h, w), dtype=torch.long, device=META)

    def run():
        probs = ref.sample_probs(cfg, params, torch.zeros((batch, h, w, c), device=META), eps)
        if metrics:
            for b in range(batch):
                RM.ged(probs[:, b].argmax(-1), ann, cfg["nlabels"])
                RM.sncc(probs[:, b], ann, cfg["nlabels"])

    return _count(run)


@functools.lru_cache(maxsize=None)
def _unit_flops(ref, cfg_json: str, kind: str, batch: int, samples: int) -> int:
    cfg = json.loads(cfg_json)
    if kind == "train":
        return train_step_flops(ref, cfg, batch)
    return sample_flops(ref, cfg, batch, samples, metrics=kind == "eval")


def unit_flops(ref, cfg: Mapping, traffic: Mapping) -> int:
    """FLOPs of one unit of a traffic mix over the reference module `ref`:
    a train step, an eval batch or a sampler call."""
    return _unit_flops(ref, json.dumps(cfg, sort_keys=True), traffic["kind"], traffic["batch"],
                       traffic.get("samples", 0))


def frce_bytes(cfg: Mapping, batch: int, logit_bytes: int = 4) -> Tuple[int, int]:
    """(K1, K2) bytes of one train step: K1 reads the L levels' logits and
    the one-hot labels and writes L losses; K2 reads the levels, the labels
    and L cotangents and writes the L logit gradients. The logits are f32,
    as the source's loss takes them."""
    h, w, _ = cfg["image_size"]
    L = cfg["latent_levels"] if cfg["model_family"] == "phiseg" else 1
    level = batch * h * w * cfg["nlabels"] * logit_bytes
    labels = batch * h * w * cfg["nlabels"] * 4
    return L * level + labels + 4 * L, 2 * L * level + labels + 4 * L
