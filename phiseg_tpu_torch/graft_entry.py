"""Driver entry points (port of __graft_entry__.py): the flagship's
training forward plus objective as a function and example inputs, and a
data-parallel dry run of the full training step.

  python -m phiseg_tpu_torch.graft_entry [N] [--device cuda|cpu]

runs `dryrun_multichip(N)` (N defaults to 8, as in the JAX file). On the
card the ranks use NCCL, one a card, when there are N cards, and otherwise
share the cards over gloo; on the CPU they use gloo.
"""

from __future__ import annotations

import argparse
import math
from typing import Optional

import torch

# rank timeout of the dry run, seconds
DRYRUN_TIMEOUT = 900


def entry(device="cuda", cfg=None):
    """(fn, example_args): the training forward of `phiseg_7_5_synth` at full
    width (or of `cfg`) with its objective.

    fn(model, x, s, generator=None, eps=None) -> the scalar total loss of
    the training forward (posterior, teacher-forced prior, likelihood) in
    eval batch-norm mode and `phiseg_objective`; the posterior noise comes
    from `generator`, or is injected per level as `eps`. On a CUDA device
    the objective's CE is K1. The example args are the model (weights of
    the config's seed), zero images (2, H, W, C), zero labels (2, H, W) and
    a generator seeded 0. Without a card, "cuda" raises.
    """
    from phiseg_tpu_torch.engine.objective import phiseg_objective
    from phiseg_tpu_torch.engine.train import build_model, fused_ce_rule
    from phiseg_tpu_torch.experiments import get_experiment
    from phiseg_tpu_torch.nn.losses import one_hot
    from phiseg_tpu_torch.parallel.mesh import resolve_device

    device = resolve_device(device)
    if cfg is None:
        cfg = get_experiment("phiseg_7_5_synth")
    model = build_model(cfg, device, seed=cfg.seed)
    h, w, c = cfg.image_size
    x = torch.zeros((2, h, w, c), dtype=torch.float32, device=device)
    s = torch.zeros((2, h, w), dtype=torch.int64, device=device)
    generator = torch.Generator(device=device).manual_seed(0)

    def fn(model, x, s, generator: Optional[torch.Generator] = None, eps=None):
        s_oh = one_hot(s, cfg.nlabels)
        model.eval()
        outputs = model(x, s_oh, eps=eps, generator=generator)
        loss, _ = phiseg_objective(outputs, s_oh, cfg, model=model,
                                   use_fused_ce=fused_ce_rule(cfg.use_fused_loss_kernel, x))
        return loss

    return fn, (model, x, s, generator)


def dryrun_config(n_devices: int):
    """The dry run's config, __graft_entry__.py:142-147: the flagship's R=7 /
    L=5 topology at 64x64, n0=4, f32, batch 2 a rank."""
    from phiseg_tpu_torch.experiments import get_experiment

    return get_experiment("phiseg_7_5_synth").replace(
        image_size=(64, 64, 1), batch_size=2 * n_devices, compute_dtype="float32", n0=4)


def _dryrun_rank(n_devices: int, device: str, steps: int):
    """One rank of the dry run: `steps` steps of the full production step
    (on-device augmentation, forward, backward, Adam, sync-BN, K3) on its
    shard of a zero batch. Returns (global total losses, kernel launches)."""
    from phiseg_tpu_torch.data.augment_device import make_augment_fn
    from phiseg_tpu_torch.engine.train import create_train_state, make_train_step
    from phiseg_tpu_torch.ops import fused_residual_ce as frce
    from phiseg_tpu_torch.parallel import make_mesh, shard_array, shard_train_step

    cfg = dryrun_config(n_devices)
    mesh = make_mesh(n_devices, device=device)
    state = create_train_state(cfg, mesh.device)
    step = make_train_step(cfg, make_augment_fn(cfg.augmentation_options, cfg.nlabels),
                           mesh=mesh)
    step, state = shard_train_step(step, state, mesh)
    h, w, c = cfg.image_size
    x = shard_array(torch.zeros((cfg.batch_size, h, w, c), device=mesh.device), mesh)
    s = shard_array(torch.zeros((cfg.batch_size, h, w), dtype=torch.int64,
                                device=mesh.device), mesh)
    frce.reset_launch_counts()
    losses = []
    for _ in range(steps):
        # the same draws every step, as the JAX dry run passes one key to
        # every step: the losses move by the optimiser alone
        generator = torch.Generator(device=mesh.device).manual_seed(cfg.seed + mesh.rank)
        losses.append(float(step(state, x, s, generator)["total_loss"]))
    return losses, dict(frce.LAUNCHES)


def dryrun_multichip(n_devices: int, device="cuda", steps: int = 3):
    """Run the FULL data-parallel training step over `n_devices` local
    ranks for `steps` steps at __graft_entry__.py's tiny shapes (batch
    sharded, parameters replicated, sync-BN and gradient all_reduce).

    The step-0 total is dominated by the finest level's KL, which the
    reference guards only with +1e-10 denominators: at init it is huge but
    finite (~1e10) and collapses within a few steps. So every loss must be
    finite and the last below the first, or this raises. Returns each
    rank's (losses, kernel launches), in rank order."""
    from phiseg_tpu_torch.parallel import resolve_device, spawn_ranks

    dev = resolve_device(device)
    backend = ("nccl" if dev.type == "cuda" and n_devices <= torch.cuda.device_count()
               else "gloo")
    outs = spawn_ranks(_dryrun_rank, n_devices, (n_devices, dev.type, steps), backend=backend,
                       timeout=DRYRUN_TIMEOUT)
    for rank, (losses, _) in enumerate(outs):
        if not all(math.isfinite(v) for v in losses):
            raise FloatingPointError(f"rank {rank}: non-finite dry-run loss {losses}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"rank {rank}: the init-KL transient did not shrink: {losses}")
    losses = outs[0][0]
    traj = " -> ".join(f"{v:.4g}" for v in losses)
    print(f"dryrun_multichip({n_devices}): ok, loss={losses[-1]:.4f} "
          f"(init-KL transient {traj}; {backend} ranks on {dev.type})")
    return outs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n", nargs="?", type=int, default=8, help="number of ranks")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the ranks run; cuda without a card raises")
    a = p.parse_args(argv)
    return dryrun_multichip(a.n, a.device)


if __name__ == "__main__":
    main()
