"""Training CLI (port of phiseg_tpu/cli/train.py:21-87).

Usage:
  python -m phiseg_tpu_torch.cli.train phiseg_7_5_synth --num-iter 2000
  python -m phiseg_tpu_torch.cli.train path/to/config.json   # a config snapshot
  python -m phiseg_tpu_torch.cli.train phiseg_7_5_synth --mesh 4   # 4 local cards
  torchrun --nproc-per-node 4 -m phiseg_tpu_torch.cli.train phiseg_7_5_synth --distributed

The trainer validates every `validation_frequency` steps, keeps the
`latest` and `best_dice` / `best_loss` / `best_ged` / `best_ncc` checkpoints
and `best_metrics.json` in the log dir, and saves `latest` when it ends. A
run in a log dir that holds a `latest` checkpoint resumes from its step, up
to `--num-iter`; `--no-resume` starts from step 0 instead. The checkpoint
may be the port's `.pt` or the `.msgpack` of a run that phiseg_tpu trained:

  python -m phiseg_tpu_torch.cli.train <jax_log_dir>/config.json --log-dir <jax_log_dir>

carries that run on from its step (weights, batch-norm statistics, Adam
state), writes `.pt` checkpoints beside the `.msgpack` ones (which stay as
they are) and appends to its `metrics.jsonl`. The config must hold the
model of the log dir's config.json, or the run raises naming the field.
`python -m phiseg_tpu_torch.cli.test_quantitative <log_dir>` then scores
the `best_ged` checkpoint.

The arguments are the JAX CLI's, plus `--device` (default cuda: without a
card it raises; pass `--device cpu` to train on the CPU). `--mesh N` starts
N local ranks, one per card, and trains data-parallel over them (the global
batch is the config's); `--distributed` joins the process group that
torchrun's environment describes. The backend is NCCL on cuda and gloo on
the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("experiment", help="experiment name or config.json path")
    p.add_argument("--data", default=None, choices=[None, "lidc", "synthetic"],
                   help="override the config's dataset")
    p.add_argument("--num-iter", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to train; cuda without a card raises")
    p.add_argument("--mesh", type=int, default=None,
                   help="number of local ranks (one per card) for data-parallel training")
    p.add_argument("--no-resume", action="store_true",
                   help="start from step 0 even if the log dir holds a checkpoint")
    p.add_argument("--dtype", default=None, choices=[None, "float32", "bfloat16"])
    p.add_argument("--distributed", action="store_true",
                   help="join the process group of torchrun's environment "
                        "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    p.add_argument("--no-image-summaries", action="store_true",
                   help="disable TB image grids / per-level output maps")
    p.add_argument("--no-histogram-summaries", action="store_true",
                   help="disable TB weight/activation histograms")
    return p.parse_args(argv)


def resolve_config(name_or_path: str):
    from phiseg_tpu_torch.engine.config import ExperimentConfig

    if os.path.exists(name_or_path):
        return ExperimentConfig.load(name_or_path)
    from phiseg_tpu_torch.experiments import get_experiment

    return get_experiment(name_or_path)


def _train(cfg, log_dir, device, mesh=None, resume=True):
    from phiseg_tpu_torch.data import get_dataset
    from phiseg_tpu_torch.engine.trainer import Trainer

    data = get_dataset(cfg)
    trainer = Trainer(cfg, log_dir=log_dir, device=device, mesh=mesh, resume=resume)
    trainer.train(data)
    return trainer


def _train_rank(cfg_json: str, log_dir, device: str, num_devices: int, resume: bool = True):
    """One rank of `--mesh N` (runs in a process of its own): the step it
    reached and its kernels' launch counts over the run."""
    from phiseg_tpu_torch.engine.config import ExperimentConfig
    from phiseg_tpu_torch.ops import fused_residual_ce as frce
    from phiseg_tpu_torch.parallel import make_mesh

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    mesh = make_mesh(num_devices, device=device)
    frce.reset_launch_counts()
    step = _train(ExperimentConfig.from_json(cfg_json), log_dir, device, mesh,
                  resume).state.step
    return step, dict(frce.LAUNCHES)


def main(argv=None, timeout=None):
    """Train the named experiment. Returns the Trainer after the last step;
    with `--mesh`, each rank's (step reached, kernel launch counts), in rank
    order (`timeout` bounds the ranks' run, in seconds)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = parse_args(argv)
    cfg = resolve_config(args.experiment)
    if args.data:
        cfg = cfg.replace(data_identifier=args.data)
    if args.num_iter is not None:
        cfg = cfg.replace(num_iter=args.num_iter)
    if args.batch_size is not None:
        cfg = cfg.replace(batch_size=args.batch_size)
    if args.dtype is not None:
        cfg = cfg.replace(compute_dtype=args.dtype)
    if args.no_image_summaries:
        cfg = cfg.replace(do_image_summaries=False)
    if args.no_histogram_summaries:
        cfg = cfg.replace(do_histogram_summaries=False)

    import torch

    from phiseg_tpu_torch import parallel

    parallel.resolve_device(args.device)  # cuda without a card raises here
    resume = not args.no_resume
    if args.distributed:
        parallel.init_distributed_from_env(device=args.device)
        try:
            return _train(cfg, args.log_dir, args.device,
                          parallel.make_mesh(args.mesh, device=args.device), resume)
        finally:
            torch.distributed.destroy_process_group()
    if args.mesh:
        backend = parallel.local_backend(args.device, args.mesh)
        return parallel.spawn_ranks(_train_rank, args.mesh,
                                    (cfg.to_json(), args.log_dir, args.device, args.mesh,
                                     resume),
                                    backend=backend, timeout=timeout)
    return _train(cfg, args.log_dir, args.device, resume=resume)


if __name__ == "__main__":
    main()
