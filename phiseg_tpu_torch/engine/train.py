"""Model, optimiser, train-step, eval-loss and sampler factories (port of
phiseg_tpu/engine/train.py:27-257).

One train step runs: augmentation -> one-hot -> SegVAE forward -> objective
-> backward -> optimiser update. The batch-norm running statistics update
inside the forward, as the Flax `mutable=["batch_stats"]` apply does. The
learning-rate dict schedule (ref utils.py:70-84 `find_floor_in_list`) is
looked up on the host from the step counter. Under a mesh the step runs on
this rank's batch shard with sync-BN and global losses, and averages the
gradients over the ranks between backward and the optimiser.

The samplers encode x once and decode all S draws as one S x B batch in
eval batch-norm mode, where the JAX package vmaps a decode over S keys.

Spans (utils/profiling.span; nothing but one check each with no profiler
running) name the phases: `train_step` (unit: the state's step) with
`train_step.augment`, `.forward` (one-hot, forward, objective; the
HPU-Net's `.geco` inside it), `.backward` (zero_grad, backward),
`.grad_allreduce` (under a mesh) and `.optimizer` (the rate and the
update), which a step made of a CUDA graph runs only at its capture, inside
`train_step.capture`; its other calls are `train_step.replay`. The
sampler's `sample.encode`, `sample.decode` (noise, the S x B decode, the
level sum; `sample.decode.tile` around the cache's tiling inside it, and
the HPU-Net's `.latents` and `.stitch`), `sample.softmax` and
`sample.assemble` (under a mesh), with CUDA events on x's device and the
sampler's call count as their unit.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import itertools
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from phiseg_tpu_torch.engine import step_graph
from phiseg_tpu_torch.engine.config import ExperimentConfig
from phiseg_tpu_torch.engine.objective import geco_objective, phiseg_objective
from phiseg_tpu_torch.models import HPUNet, SegVAE, aggregate_levels, model_class
from phiseg_tpu_torch.nn.layers import set_batch_norm_mesh
from phiseg_tpu_torch.nn.losses import one_hot
from phiseg_tpu_torch.parallel.mesh import DeviceLike, resolve_device
from phiseg_tpu_torch.utils.profiling import span


def build_model(cfg: ExperimentConfig, device: DeviceLike = "cuda",
                seed: Optional[int] = None) -> SegVAE:
    """The config's SegVAE (its family's class, `models.model_class`) on
    `device`: the card unless the caller asks for the CPU (without a card,
    "cuda" raises). With `seed`, its weights are drawn on the CPU from a
    generator with that seed (so every device gets the same init) before the
    move, by the class's `init_weights_`: Flax's init, or the HPU-Net's
    published one."""
    device = resolve_device(device)
    model = model_class(cfg.model_family)(
        model_family=cfg.model_family,
        zdim0=cfg.zdim0,
        n0=cfg.n0,
        latent_levels=cfg.latent_levels,
        resolution_levels=cfg.resolution_levels,
        nlabels=cfg.nlabels,
        image_size=cfg.image_hw,
        norm=cfg.norm,
        dtype=cfg.dtype,
        image_channels=cfg.image_size[2],
    )
    if seed is not None:
        model.init_weights_(torch.Generator().manual_seed(seed))
    return model.to(device)


def lr_schedule_from_dict(schedule: Mapping[int, float]) -> Callable[[int], float]:
    """Step-threshold dict -> piecewise-constant schedule: the value of the
    largest key <= step, or of the first key before it (ref :186-190)."""
    steps = sorted(schedule)
    values = [float(schedule[s]) for s in steps]

    def fn(step: int) -> float:
        return values[max(bisect.bisect_right(steps, step) - 1, 0)]

    return fn


def make_optimizer(cfg: ExperimentConfig, params) -> torch.optim.Optimizer:
    """The config's optimiser at the schedule's first rate; the train step
    sets each step's rate."""
    lr = lr_schedule_from_dict(cfg.lr_schedule)(0)
    if cfg.optimizer == "adam":
        # TF and optax defaults; torch's Adam is the same update rule
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if cfg.optimizer == "momentum":
        # Nesterov momentum 0.9 (ref phiseg_model.py:137-140)
        return torch.optim.SGD(params, lr=lr, momentum=0.9, nesterov=True)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=lr)
    raise ValueError(f"unknown optimizer: {cfg.optimizer!r}")


@dataclasses.dataclass
class TrainState:
    """The model (parameters and batch-norm statistics), its optimiser and
    the step counter; a train step updates all three in place."""

    model: SegVAE
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(cfg: ExperimentConfig, device: DeviceLike = "cuda",
                       seed: Optional[int] = None) -> TrainState:
    """The model of `build_model` (on the card unless asked for the CPU,
    weights from `seed`, else the config's) and its optimiser, at step 0."""
    model = build_model(cfg, device, cfg.seed if seed is None else seed)
    return TrainState(model=model, optimizer=make_optimizer(cfg, model.parameters()))


AugmentFn = Callable[..., tuple]


def make_train_step(cfg: ExperimentConfig, augment_fn: Optional[AugmentFn] = None,
                    use_fused_ce: Optional[bool] = None, mesh=None, capture: bool = True):
    """Build step(state, x, s, generator=None, eps=None) -> loss dict.

    x: (B,H,W,Cin) float; s: (B,H,W) integer labels, both on the model's
    device. `generator` draws the augmentation and the posterior noise;
    `eps` injects the noise instead (per level, NHWC like z). The returned
    losses are detached device tensors. use_fused_ce=None uses the fused
    residual-CE kernels when x is on a CUDA device.

    On the card, with a generator and without `eps` or a mesh, the step is
    one CUDA graph (engine/step_graph.py): captured at the first call and
    again when the batch's shapes, the state, the generator or the rate
    change, replayed at every call. Elsewhere, or with capture=False (a
    test's eager twin), it runs eagerly.

    The HPU-Net (models.HPUNet) trains on objective.geco_objective instead,
    whose top-k draws one uniform a pixel from `generator` after the
    posterior's normals (augmentation, then the posterior's levels from the
    coarsest, then the uniforms), and clamps its multiplier at >= 0 after
    the optimiser's step. It takes no mesh.

    With a mesh (parallel.mesh.Mesh), x and s are this rank's shard of the
    global batch, batch norm is sync-BN, the losses are global means, and
    the gradients are averaged over the ranks before the optimiser; pass the
    step and state through parallel.shard_train_step first.
    """
    lr_fn = lr_schedule_from_dict(cfg.lr_schedule)
    sync_bn_model = None  # the model whose batch norms this step made sync-BN
    geco = _trains_on_geco(cfg)

    def one_step(state: TrainState, x: torch.Tensor, s: torch.Tensor,
                 generator: Optional[torch.Generator], eps: Optional[Sequence[torch.Tensor]],
                 lr: float) -> Dict[str, torch.Tensor]:
        nonlocal sync_bn_model
        fused = fused_ce_rule(use_fused_ce, x)
        if augment_fn is not None:
            with span("train_step.augment"):
                x, s = augment_fn(x, s, generator)
        model, opt = state.model, state.optimizer
        with span("train_step.forward"):
            s_oh = one_hot(s, cfg.nlabels)
            model.train()
            if mesh is not None and model is not sync_bn_model:
                set_batch_norm_mesh(model, mesh)
                sync_bn_model = model
            outputs = model(x, s_oh, eps=eps, generator=generator)
            loss, loss_dict = _objective(cfg, geco, outputs, s_oh, model, generator, fused,
                                         mesh)
        with span("train_step.backward"):
            opt.zero_grad(set_to_none=True)
            loss.backward()
        if mesh is not None:
            with span("train_step.grad_allreduce"):
                mesh.average_gradients(list(model.parameters()))
        with span("train_step.optimizer"):
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
            if geco:
                model.geco.clamp_()
        return loss_dict

    graph = step_graph.StepGraph(one_step) if capture else None

    def step(state: TrainState, x: torch.Tensor, s: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             eps: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        with span("train_step", state.step):
            lr = lr_fn(state.step)
            if graph is not None and step_graph.capturable(x, generator, eps, mesh,
                                                           state.optimizer):
                losses = graph(state, x, s, generator, lr)
            else:
                step_graph.COUNTS["eager"] += 1
                losses = {k: v.detach() for k, v in one_step(state, x, s, generator, eps,
                                                             lr).items()}
            state.step += 1
            return losses

    step.mesh = mesh
    return step


def _trains_on_geco(cfg: ExperimentConfig) -> bool:
    """Whether the config's family trains on GECO: the HPU-Net's class."""
    return issubclass(model_class(cfg.model_family), HPUNet)


def _objective(cfg: ExperimentConfig, geco: bool, outputs, s_oh: torch.Tensor, model: SegVAE,
               generator: Optional[torch.Generator], use_fused_ce: bool, mesh=None):
    """The family's objective: GECO for the HPU-Net, PHiSeg's for the others."""
    if geco:
        return geco_objective(outputs, s_oh, model, generator, mesh)
    return phiseg_objective(outputs, s_oh, cfg, model=model, use_fused_ce=use_fused_ce, mesh=mesh)


def fused_ce_rule(use_fused_ce: Optional[bool], x: torch.Tensor) -> bool:
    """Whether the objective's CE goes through the fused kernels: the
    flag (`cfg.use_fused_loss_kernel` in the trainer), where None means when
    x is on a CUDA device."""
    return x.is_cuda if use_fused_ce is None else use_fused_ce


def make_eval_loss_fn(model: SegVAE, cfg: ExperimentConfig):
    """Batch losses in eval batch-norm mode, without autograd (ref
    _do_validation :537-549; JAX engine/train.py:197-207): build
    eval_loss(x, s, generator=None, eps=None) -> loss dict of detached
    tensors. The CE goes through K1 by `fused_ce_rule` of
    `cfg.use_fused_loss_kernel`; the HPU-Net's GECO loss reads its moving
    average without advancing it."""
    geco = _trains_on_geco(cfg)

    def eval_loss(x: torch.Tensor, s: torch.Tensor, generator: Optional[torch.Generator] = None,
                  eps: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        s_oh = one_hot(s, cfg.nlabels)
        with torch.no_grad(), _eval_mode(model):
            outputs = model(x, s_oh, eps=eps, generator=generator)
            _, loss_dict = _objective(cfg, geco, outputs, s_oh, model, generator,
                                      fused_ce_rule(cfg.use_fused_loss_kernel, x))
        return loss_dict

    return eval_loss


@contextlib.contextmanager
def _eval_mode(model: torch.nn.Module):
    was_training = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(was_training)


def _draw_range(num_samples: int, mesh) -> Tuple[int, int]:
    """The draws [lo, hi) this rank decodes: all of them without a mesh."""
    if mesh is None:
        return 0, num_samples
    if num_samples % mesh.world_size:
        raise ValueError(f"{num_samples} samples do not split over {mesh.world_size} ranks")
    per = num_samples // mesh.world_size
    return mesh.rank * per, (mesh.rank + 1) * per


def _decode_draws(model: SegVAE, cache, x: torch.Tensor, num_samples: int, lo: int, hi: int,
                  generator: Optional[torch.Generator],
                  eps: Optional[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
    """Per-level logits (hi-lo, B, H, W, C) of draws lo..hi-1 of num_samples,
    from the prior's `cache` of x (`model.sample_cache(x)`).

    Each level's noise for ALL draws comes from `generator` in one call
    (S, *latent shape), so a rank that decodes a share of the draws gets the
    same noise as a single device: sharding does not change the draws.
    `eps` injects that noise instead. A model without latents decodes once
    and repeats it, the S identical draws of JAX's vmap over unused keys.
    """
    n = hi - lo
    if not model.has_latents:
        return [t.expand(n, *t.shape) for t in model.decode_sample(cache)]
    b = x.shape[0]
    if eps is None:
        eps = [torch.randn((num_samples, *shape), generator=generator, device=x.device,
                           dtype=model.dtype)
               for shape in model.latent_shapes(b)]
    eps = [e[lo:hi].reshape(n * b, *e.shape[2:]) for e in eps]
    with span("sample.decode.tile", device=x.device):
        cache = model.repeat_cache(cache, n)
    return [t.reshape(n, b, *t.shape[1:]) for t in model.decode_sample(cache, eps=eps)]


def _assemble(part: torch.Tensor, num_samples: int, lo: int, mesh) -> torch.Tensor:
    """Every rank's share of the draws in one (S, ...) tensor on every rank:
    an all_reduce of a zero-filled buffer, in which each rank wrote its
    share (exact, since the other ranks add zeros)."""
    full = torch.zeros((num_samples, *part.shape[1:]), dtype=part.dtype, device=part.device)
    full[lo:lo + part.shape[0]] = part
    return mesh.all_reduce_(full)


def make_sample_fn(model: SegVAE, num_samples: int, return_probs: bool = True, mesh=None):
    """N-sample prior inference (ref engine/train.py:210-240): build
    sample(x, generator=None, eps=None) -> (S, B, H, W, C) f32 softmax
    probabilities (or logits).

    x (B,H,W,Cin) is encoded once and the S draws are decoded as one S x B
    batch, in eval batch-norm mode, without autograd. With a mesh, each rank
    decodes S/N of the draws from the same cache and every rank returns all
    S.
    """
    lo, hi = _draw_range(num_samples, mesh)
    calls = itertools.count()

    def sample(x: torch.Tensor, generator: Optional[torch.Generator] = None,
               eps: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        unit, dev = next(calls), x.device
        with torch.no_grad(), _eval_mode(model):
            with span("sample.encode", unit, dev):
                cache = model.sample_cache(x)
            with span("sample.decode", unit, dev):
                out = aggregate_levels(_decode_draws(model, cache, x, num_samples, lo, hi,
                                                     generator, eps))
            if return_probs:
                with span("sample.softmax", unit, dev):
                    out = torch.softmax(out, dim=-1)
            if mesh is not None:
                with span("sample.assemble", unit, dev):
                    out = _assemble(out, num_samples, lo, mesh)
            return out

    return sample


def make_sample_levels_fn(model: SegVAE, num_samples: int):
    """Like make_sample_fn but returns the per-level logits, each
    (S, B, H, W, C) (ref predict_segmentation_sample_levels :367-375)."""

    def sample(x: torch.Tensor, generator: Optional[torch.Generator] = None,
               eps: Optional[Sequence[torch.Tensor]] = None) -> Tuple[torch.Tensor, ...]:
        with torch.no_grad(), _eval_mode(model):
            return tuple(_decode_draws(model, model.sample_cache(x), x, num_samples, 0, num_samples,
                                       generator, eps))

    return sample
