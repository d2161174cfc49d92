"""The training loop (port of the loop of phiseg_tpu/engine/trainer.py:46-287).

A background thread prefetches host batches; each step copies the batch to
the device (labels as uint8), runs the train step (on-device augmentation,
forward, objective, backward, Adam, BN statistics) and, every
`tensorboard_update_frequency` steps, brings the losses to the host, stops
on a non-finite loss, and writes the scalars to TensorBoard and
`metrics.jsonl` with the images/s since the last report.

The trainer runs on the card unless it is asked for the CPU: device "cuda"
without a card raises. With a mesh (parallel.mesh.Mesh) it is one rank of a
data-parallel run (ref trainer.py:120, 166-171, 193-199): every rank pulls
the same global batch and puts its slice on its device, the augmentation and
posterior noise are drawn from a generator seeded per rank, the losses are
global means, and only rank 0 writes config.json, TensorBoard and
`metrics.jsonl`. images/s counts the global batch.

Validation, checkpoints and resume are not ported yet (ROADMAP Queue 1,
item 10): the loop raises when it reaches a validation step, and the final
state is not saved.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from phiseg_tpu_torch.data.augment_device import make_augment_fn
from phiseg_tpu_torch.engine.config import ExperimentConfig, log_root
from phiseg_tpu_torch.engine.train import (
    create_train_state,
    lr_schedule_from_dict,
    make_train_step,
)
from phiseg_tpu_torch.parallel.mesh import resolve_device, shard_host_batch, shard_train_step
from phiseg_tpu_torch.utils.tb_writer import SummaryWriter

log = logging.getLogger(__name__)


class _Prefetcher:
    """Background thread pulling host batches ahead of the device. An error
    in the provider is handed to the consumer, which raises it."""

    def __init__(self, provider, batch_size: int, depth: int = 2):
        self.provider = provider
        self.batch_size = batch_size
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        try:
            while not self._stop.is_set():
                self._put(self.provider.next_batch(self.batch_size))
        except Exception as e:  # noqa: BLE001 -- re-raised by next()
            self._put(e)

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def next(self):
        item = self.q.get()
        if isinstance(item, Exception):
            raise RuntimeError("the batch prefetch thread failed") from item
        return item

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.t.join(timeout=5.0)


def write_metrics_jsonl(path: str, step: int, metrics: dict) -> None:
    """Append one structured metrics record (phiseg_tpu/engine/checkpoint.py:273-282)."""
    rec = {"step": int(step)}
    for k, v in metrics.items():
        try:
            rec[k] = float(v)
        except (TypeError, ValueError):
            rec[k] = v
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s augmentation and noise generator: `seed`
    itself on rank 0 (a run without a mesh is rank 0), a distinct seed on
    every other rank, so no two ranks draw the same noise. The rank moves
    the low 32 bits, the only ones a CPU generator keeps."""
    return (seed + 0x9E3779B9 * rank) % 2 ** 32


class Trainer:
    def __init__(self, cfg: ExperimentConfig, log_dir: Optional[str] = None,
                 device: str = "cuda", mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.is_chief = mesh is None or mesh.rank == 0
        self.log_dir = log_dir or os.path.join(log_root(), cfg.log_dir_name, cfg.experiment_name)
        if self.is_chief:
            os.makedirs(self.log_dir, exist_ok=True)
            # Config snapshot for provenance (ref phiseg_train.py:44-47).
            cfg.save(os.path.join(self.log_dir, "config.json"))

        self.state = create_train_state(cfg, self.device)
        augment_fn = None
        if cfg.augment_on_device and cfg.augmentation_options:
            augment_fn = make_augment_fn(cfg.augmentation_options, cfg.nlabels)
        self.train_step = make_train_step(cfg, augment_fn=augment_fn,
                                          use_fused_ce=cfg.use_fused_loss_kernel, mesh=mesh)
        if mesh is not None:
            self.train_step, self.state = shard_train_step(self.train_step, self.state, mesh)
        rank = 0 if mesh is None else mesh.rank
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(cfg.seed + 1, rank))
        self.writer = SummaryWriter(self.log_dir) if self.is_chief else None
        self.metrics_path = os.path.join(self.log_dir, "metrics.jsonl")
        self._lr = lr_schedule_from_dict(cfg.lr_schedule)

    def _to_device(self, x, s):
        """Host batch -> device tensors (this rank's slice under a mesh):
        images f32, labels uint8."""
        if self.mesh is not None:
            x, s = shard_host_batch(x, self.mesh), shard_host_batch(s, self.mesh)
        s = np.asarray(s)
        if self.cfg.nlabels <= 255 and s.dtype != np.uint8:
            s = s.astype(np.uint8)
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        s = torch.from_numpy(np.ascontiguousarray(s))
        return x.to(self.device, non_blocking=True), s.to(self.device, non_blocking=True)

    def train(self, data):
        cfg = self.cfg
        prefetch = _Prefetcher(data.train, cfg.batch_size)
        try:
            t_last = time.perf_counter()
            for step in range(cfg.num_iter):
                x, s = self._to_device(*prefetch.next())
                loss_dict = self.train_step(self.state, x, s, self.generator)

                if step % cfg.tensorboard_update_frequency == 0:
                    loss_dict = {k: float(v) for k, v in loss_dict.items()}
                    # numerical-failure detection (trainer.py:231-237)
                    if not np.isfinite(loss_dict["total_loss"]):
                        bad = [k for k, v in loss_dict.items() if not np.isfinite(v)]
                        raise FloatingPointError(
                            f"non-finite loss at step {step}: {bad}. Set "
                            "torch.autograd.set_detect_anomaly(True) to localise the op."
                        )
                    now = time.perf_counter()
                    dt, t_last = now - t_last, now
                    ips = cfg.batch_size * cfg.tensorboard_update_frequency / dt if step else 0.0
                    scalars = {f"batch_{k}": v for k, v in loss_dict.items()}
                    scalars["images_per_sec"] = ips  # cfg.batch_size is the global batch
                    scalars["learning_rate"] = self._lr(step)
                    if self.is_chief:
                        self.writer.scalars(scalars, step)
                        self.writer.flush()
                        write_metrics_jsonl(self.metrics_path, step, scalars)
                    log.info("step %d: loss %.4f (%.1f img/s)", step,
                             loss_dict["total_loss"], ips)

                if step % cfg.validation_frequency == 0 and step > 0:
                    raise NotImplementedError(
                        f"step {step} is a validation step, and validation is not "
                        "ported yet (ROADMAP Queue 1 item 10: the trainer, checkpoints "
                        "and validation); set validation_frequency above num_iter"
                    )
            log.warning("checkpoints are not ported yet: the final state is not saved")
        finally:
            prefetch.stop()
            if self.writer is not None:
                self.writer.close()
        return self.state
