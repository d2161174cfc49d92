"""The training loop: steps, monitoring, validation, checkpoints, resume
(port of phiseg_tpu/engine/trainer.py:98-470).

Equivalent of the reference engine's session loop (phiseg/phiseg_model.py:
166-207 train, :530-701 validation with multi-criterion best checkpoints,
:821-848 auto-resume). A background thread prefetches host batches; each
step copies the batch to the device (labels as uint8), runs the train step
(on-device augmentation, forward, objective, backward, Adam, BN statistics)
and, every `tensorboard_update_frequency` steps, brings the losses to the
host, stops on a non-finite loss, and writes the scalars to TensorBoard and
`metrics.jsonl` with the images/s since the last report.

Every `validation_frequency` steps (not at the first step of a run) the
trainer validates (`do_validation`): it saves `latest`, computes the
eval-mode batch losses of one validation batch and of the next batch of the
training stream (as the JAX trainer does, that batch is not trained on),
Dice, GED^2, S_NCC and the ELBO over the validation images, saves the best_dice / best_loss / best_ged / best_ncc checkpoints
that improved, and writes the diagnostics. A run resumes from the newest
`latest` checkpoint by the state's own step: the port's `.pt`, with the
trainer's noise generator where it was, or the `.msgpack` of a run that
phiseg_tpu's Trainer wrote (weights, batch-norm statistics, optax's Adam or
momentum state, step; engine/checkpoint.load_tag), which holds no torch
generator, so the generator is seeded from the step. The run then writes
`.pt` checkpoints beside the `.msgpack` ones, which it never prunes or
rewrites. A resume requires the config's CHECKPOINT_FIELDS to equal those of
the log dir's config.json; config.json is rewritten only when the config
differs from it. The final state is saved as `latest` when the loop ends
normally. Checkpoint writes go through an ordered writer thread
(`async_checkpointing`), drained when `train` returns or raises. With
PHISEG_PROFILE_DIR set, the steps of PHISEG_PROFILE_STEPS are traced into
it (utils/profiling.py; JAX trainer.py:206-225), each with its report and
validation. Spans (utils/profiling.span): `data.wait` (the wait for the
prefetch thread, with that thread's CPU clock at entry), `data.to_device`,
`train.report`, `validation` and `checkpoint.snapshot` (the host copy of
the state a validation saves).

The trainer runs on the card unless it is asked for the CPU: device "cuda"
without a card raises. With a mesh (parallel.mesh.Mesh) it is one rank of a
data-parallel run (ref trainer.py:120, 166-171, 193-199): every rank pulls
the same global batch and puts its slice on its device, the augmentation and
posterior noise come from a generator seeded per rank, the losses are global
means, and only rank 0 writes config.json, TensorBoard, `metrics.jsonl` and
checkpoints, and validates; the other ranks take the same batch off their
training stream and wait for rank 0 at one broadcast.
A rank 0 resumed from a `.pt` takes the saved generator state; the other
ranks, and every rank resumed from a `.msgpack`, seed theirs from the seed,
their rank and the step.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from phiseg_tpu_torch.data.augment_device import make_augment_fn
from phiseg_tpu_torch.engine.checkpoint import (
    JAX_SUFFIX,
    CheckpointManager,
    host_snapshot,
    load_tag,
    newest_checkpoint,
    write_metrics_jsonl,
)
from phiseg_tpu_torch.engine.config import CHECKPOINT_FIELDS, ExperimentConfig, log_root
from phiseg_tpu_torch.engine.train import (
    create_train_state,
    lr_schedule_from_dict,
    make_eval_loss_fn,
    make_sample_fn,
    make_train_step,
)
from phiseg_tpu_torch.engine.validation import make_validation_fn
from phiseg_tpu_torch.parallel.mesh import resolve_device, shard_host_batch, shard_train_step
from phiseg_tpu_torch.utils.profiling import StepProfiler, span
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
        with span("data.wait") as rec:
            if rec is not None:
                rec.value = self._producer_cpu_ns()
            item = self.q.get()
        if isinstance(item, Exception):
            raise RuntimeError("the batch prefetch thread failed") from item
        return item

    def _producer_cpu_ns(self) -> Optional[int]:
        """The prefetch thread's CPU clock, read from the calling thread
        (a profiler started after the thread cannot see it); None once the
        thread has ended."""
        if not self.t.is_alive():
            return None
        try:
            return time.clock_gettime_ns(time.pthread_getcpuclockid(self.t.ident))
        except OSError:  # it ended in between
            return None

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.t.join(timeout=5.0)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s augmentation and noise generator: `seed`
    itself on rank 0 (a run without a mesh is rank 0), a distinct seed on
    every other rank, so no two ranks draw the same noise. The rank moves
    the low 32 bits, the only ones a CPU generator keeps."""
    return (seed + 0x9E3779B9 * rank) % 2 ** 32


def _require_same_checkpoint_fields(saved: ExperimentConfig, cfg: ExperimentConfig,
                                    log_dir: str) -> None:
    """Raise ValueError naming each CHECKPOINT_FIELDS entry in which `cfg`
    differs from the config.json of the log dir it resumes."""
    diff = [f"{f}={getattr(saved, f)!r} there, {getattr(cfg, f)!r} here"
            for f in CHECKPOINT_FIELDS if getattr(saved, f) != getattr(cfg, f)]
    if diff:
        raise ValueError(f"the checkpoints in {log_dir} hold another model than this config: "
                         + "; ".join(diff) + " (its config.json; pass resume=False or "
                         "--no-resume to start afresh)")


def _read_text(path: str) -> Optional[str]:
    """The file's text, or None where there is none."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read()


class Trainer:
    def __init__(self, cfg: ExperimentConfig, log_dir: Optional[str] = None,
                 device: str = "cuda", mesh=None, resume: bool = True):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.is_chief = mesh is None or mesh.rank == 0
        self.log_dir = log_dir or os.path.join(log_root(), cfg.log_dir_name, cfg.experiment_name)
        # (step, suffix) of the `latest` checkpoint this run resumes from
        self.resumed_from = newest_checkpoint(self.log_dir, "latest") if resume else None
        config_path = os.path.join(self.log_dir, "config.json")
        if self.resumed_from is not None and os.path.exists(config_path):
            _require_same_checkpoint_fields(ExperimentConfig.load(config_path), cfg,
                                            self.log_dir)
        if self.is_chief:
            os.makedirs(self.log_dir, exist_ok=True)
            # Config snapshot for provenance; the eval CLIs reload it
            # (ref phiseg_train.py:44-47, phiseg_test_quantitative.py:94-97).
            # Left as it is when it holds this config's text (a phiseg_tpu
            # log dir's file stays byte for byte).
            if _read_text(config_path) != cfg.to_json():
                cfg.save(config_path)

        self.state = create_train_state(cfg, self.device)
        rank = 0 if mesh is None else mesh.rank
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(cfg.seed + 1, rank))
        self.ckpt = CheckpointManager(self.log_dir, keep=cfg.checkpoint_keep,
                                      archive_every_hours=cfg.archive_every_hours,
                                      async_writes=cfg.async_checkpointing)
        self.init_step = 0
        self.best = {"dice": -1.0, "loss": np.inf, "ged": np.inf, "ncc": -1.0}
        self._best_path = os.path.join(self.log_dir, "best_metrics.json")
        if self.resumed_from is not None:
            load_tag(self.state, self.log_dir, "latest",
                     generator=self.generator if rank == 0 else None)
            # resume from the state's own counter (the file name is a label)
            self.init_step = self.state.step
            if rank or self.resumed_from[1] == JAX_SUFFIX:
                self.generator.manual_seed(rank_seed(cfg.seed + 1 + self.init_step, rank))
            log.info("resuming from step %d", self.init_step)
            # Documented deviation (cfg.persist_best_metrics): reload the best
            # values so the first validation after a resume cannot clobber a
            # better best_* checkpoint (the reference resets them on every
            # train() start, phiseg_model.py:180-184).
            if cfg.persist_best_metrics and os.path.exists(self._best_path):
                with open(self._best_path) as f:
                    self.best.update({k: float(v) for k, v in json.load(f).items()})
                log.info("restored best metrics: %s", self.best)

        augment_fn = None
        if cfg.augment_on_device and cfg.augmentation_options:
            augment_fn = make_augment_fn(cfg.augmentation_options, cfg.nlabels)
        self.train_step = make_train_step(cfg, augment_fn=augment_fn,
                                          use_fused_ce=cfg.use_fused_loss_kernel, mesh=mesh)
        if mesh is not None:
            self.train_step, self.state = shard_train_step(self.train_step, self.state, mesh)
        self.eval_loss = make_eval_loss_fn(self.state.model, cfg)
        self.validate_fn = make_validation_fn(self.state.model, cfg)
        self.writer = SummaryWriter(self.log_dir) if self.is_chief else None
        self.metrics_path = os.path.join(self.log_dir, "metrics.jsonl")
        self._lr = lr_schedule_from_dict(cfg.lr_schedule)

    # ------------------------------------------------------------------

    def _open_writer(self):
        """The TensorBoard writer of rank 0, opened again after train()
        closed it."""
        if self.is_chief and self.writer is None:
            self.writer = SummaryWriter(self.log_dir)
        return self.writer

    def _to_device(self, x, s, shard: bool = True):
        """Host batch -> device tensors (this rank's slice under a mesh unless
        shard is False): images f32, labels uint8."""
        with span("data.to_device"):
            if shard and self.mesh is not None:
                x, s = shard_host_batch(x, self.mesh), shard_host_batch(s, self.mesh)
            s = np.asarray(s)
            if self.cfg.nlabels <= 255 and s.dtype != np.uint8:
                s = s.astype(np.uint8)
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
            s = torch.from_numpy(np.ascontiguousarray(s))
            return x.to(self.device, non_blocking=True), s.to(self.device, non_blocking=True)

    def train(self, data, num_iter: Optional[int] = None):
        """Train from the resumed step up to `num_iter` (default: the
        config's), validating and checkpointing on the way."""
        cfg = self.cfg
        num_iter = cfg.num_iter if num_iter is None else num_iter
        self._open_writer()
        prefetch = _Prefetcher(data.train, cfg.batch_size)
        # the steps of PHISEG_PROFILE_STEPS traced into PHISEG_PROFILE_DIR
        # (utils/profiling.py; JAX trainer.py:206-225)
        self.profiler = StepProfiler(self.device)
        try:
            t_last = time.perf_counter()
            for step in range(self.init_step, num_iter):
                self.profiler.maybe_start(step)
                x, s = self._to_device(*prefetch.next())
                loss_dict = self.train_step(self.state, x, s, self.generator)

                if step % cfg.tensorboard_update_frequency == 0:
                    with span("train.report", step):
                        loss_dict = {k: float(v) for k, v in loss_dict.items()}
                        # numerical-failure detection (trainer.py:231-237)
                        if not np.isfinite(loss_dict["total_loss"]):
                            bad = [k for k, v in loss_dict.items() if not np.isfinite(v)]
                            raise FloatingPointError(
                                f"non-finite loss at step {step}: {bad}. Set "
                                "torch.autograd.set_detect_anomaly(True) to localise the op; "
                                f"the last good checkpoint is in {self.log_dir}.")
                        now = time.perf_counter()
                        dt, t_last = now - t_last, now
                        ips = (cfg.batch_size * cfg.tensorboard_update_frequency / dt
                               if step > self.init_step else 0.0)
                        scalars = {f"batch_{k}": v for k, v in loss_dict.items()}
                        scalars["images_per_sec"] = ips  # cfg.batch_size is the global batch
                        scalars["learning_rate"] = self._lr(step)
                        if self.is_chief:
                            self.writer.scalars(scalars, step)
                            self.writer.flush()
                            write_metrics_jsonl(self.metrics_path, step, scalars)
                        log.info("step %d: loss %.4f (%.1f img/s)", step,
                                 loss_dict["total_loss"], ips)

                if step % cfg.validation_frequency == 0 and step > self.init_step:
                    with span("validation", step):
                        # The diagnostics' train batch comes off the training
                        # stream on every rank, through the one thread that
                        # reads the provider, so the ranks' streams stay in step.
                        train_batch = prefetch.next()
                        if self.is_chief:
                            self.do_validation(data, step, train_batch=train_batch)
                        if self.mesh is not None:  # the other ranks wait for rank 0
                            self.mesh.broadcast_(torch.zeros(1, device=self.device))
                    t_last = time.perf_counter()  # exclude validation from img/s
                # after the step's report and validation, so a window holds them
                self.profiler.maybe_stop(step)
            # Persist the final state on normal completion only: after a
            # FloatingPointError the live state may be non-finite and must
            # not overwrite 'latest'. A run that took no step from a
            # `.msgpack` has nothing to add to it (and a `.pt` of the same
            # step would make the tag ambiguous).
            if self.is_chief and (self.state.step, JAX_SUFFIX) != self.resumed_from:
                self.ckpt.save(host_snapshot(self.state, self.generator), "latest")
        finally:
            prefetch.stop()
            self.profiler.close()  # a run that ends inside the window
            # Drain the writer even on an exception, so the writes queued at
            # the last validation land; while an exception unwinds, a writer
            # error is logged instead of raised, so it cannot mask it.
            unwinding = sys.exc_info()[0] is not None
            try:
                self.ckpt.close()
            except Exception:
                if not unwinding:
                    raise
                log.exception("checkpoint writer failed during error unwind")
            finally:
                if self.writer is not None:
                    self.writer.close()
                    self.writer = None
        return self.state

    # ------------------------------------------------------------------

    def do_validation(self, data, step: int, val_batch: int = 32, train_batch=None):
        """Full validation pass (ref _do_validation :530-701; JAX
        trainer.py:294-470). Returns the scalars it wrote. `train_batch` is
        the host batch of the train-batch losses and diagnostics; without it,
        the next one of `data.train`."""
        cfg = self.cfg
        writer = self._open_writer()
        model = self.state.model
        t0 = time.time()
        # one host snapshot for every tag saved at this step
        with span("checkpoint.snapshot", step):
            host_state = host_snapshot(self.state, self.generator)
        self.ckpt.save(host_state, "latest")  # file name label = state.step
        self.ckpt.maybe_archive(host_state)   # every-N-hours forensic history

        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 2 + step)

        # batch losses on one val + one train batch, eval mode (ref :537-549)
        vx, vs = data.validation.next_batch(cfg.batch_size)
        val_losses = self.eval_loss(*self._to_device(vx, vs, shard=False), gen)
        tx_, ts_ = data.train.next_batch(cfg.batch_size) if train_batch is None else train_batch
        train_losses = self.eval_loss(*self._to_device(tx_, ts_, shard=False), gen)

        # full metric pass over num_validation_images (ref :567-628)
        n_images = data.validation.images.shape[0]
        if cfg.num_validation_images != "all":
            n_images = min(n_images, int(cfg.num_validation_images))
        val_batch = min(val_batch, n_images)
        host_rng = np.random.RandomState(cfg.seed + step)
        dices, geds, nccs, elbos, elbo_weights = [], [], [], [], []
        for b0 in range(0, n_images, val_batch):
            b1 = min(b0 + val_batch, n_images)
            n_real = b1 - b0
            x = np.asarray(data.validation.images[b0:b1]).astype(np.float32)[..., None]
            ann = np.asarray(data.validation.labels[b0:b1]).astype(np.int32)  # (B,H,W,M)
            ann = np.transpose(ann, (0, 3, 1, 2))                              # (B,M,H,W)
            # a random annotator per image (ref :575)
            picks = host_rng.choice(list(cfg.annotator_range), size=n_real)
            s_sel = np.stack([ann[i, a] for i, a in enumerate(picks)], axis=0)
            x_d, s_d = self._to_device(x, s_sel, shard=False)
            ann_d = torch.from_numpy(ann).to(self.device)
            d, g, nc, e = self.validate_fn(x_d, ann_d, s_d, gen)
            dices.append(d.cpu().numpy())
            geds.append(g.cpu().numpy())
            nccs.append(nc.cpu().numpy())
            elbos.append(float(e))
            elbo_weights.append(n_real)

        dice_arr = np.concatenate(dices, 0)  # (N, nlabels)
        per_structure_dice = dice_arr.mean(0)
        mean_dice = float(per_structure_dice.mean())
        avg_ged = float(np.concatenate(geds).mean())
        avg_ncc = float(np.concatenate(nccs).mean())
        avg_elbo = float(np.average(elbos, weights=elbo_weights))
        log.info("VALIDATION step %d (%d images): dice %.4f | -ELBO %.4f | GED %.4f | "
                 "NCC %.4f (%.1fs)", step, n_images, mean_dice, avg_elbo, avg_ged, avg_ncc,
                 time.time() - t0)

        # multi-criterion best checkpoints (ref :638-660)
        improved = False
        if mean_dice >= self.best["dice"]:
            self.best["dice"] = mean_dice
            self.ckpt.save(host_state, "best_dice")
            improved = True
        if avg_elbo <= self.best["loss"]:
            self.best["loss"] = avg_elbo
            self.ckpt.save(host_state, "best_loss")
            improved = True
        if avg_ged <= self.best["ged"]:
            self.best["ged"] = avg_ged
            self.ckpt.save(host_state, "best_ged")
            improved = True
        if avg_ncc >= self.best["ncc"]:
            self.best["ncc"] = avg_ncc
            self.ckpt.save(host_state, "best_ncc")
            improved = True
        if improved and cfg.persist_best_metrics:
            # Published on the writer's ordered queue, after the best_* writes
            # above: a crash never leaves a json claiming best values whose
            # checkpoints did not land.
            best_snapshot, path = dict(self.best), self._best_path

            def _publish_best(best=best_snapshot, path=path):
                tmp = path + ".tmp"
                with open(tmp, "w") as f:
                    json.dump(best, f)
                os.replace(tmp, path)

            self.ckpt.submit(_publish_best)

        scalars = {
            "validation_dice_mean_score": mean_dice,
            "validation_dice_tot_score": float(dice_arr.mean()),
            "validation_neg_elbo": avg_elbo,
            "validation_GED": avg_ged,
            "validation_NCC": avg_ncc,
        }
        for i in range(cfg.nlabels):
            scalars[f"validation_dice_lbl_{i}"] = float(per_structure_dice[i])
        for k, v in val_losses.items():
            scalars[f"val_batch_{k}"] = float(v)
        for k, v in train_losses.items():
            scalars[f"train_batch_{k}"] = float(v)
        writer.scalars(scalars, step)

        # per-level diagnostics, image summaries and histograms
        # (ref _make_tensorboard_summaries :704-776, layers.py:671-677)
        if cfg.do_image_summaries or cfg.do_histogram_summaries:
            if not hasattr(self, "_diag_fn"):
                from phiseg_tpu_torch.utils.diagnostics import make_diag_fn, make_param_hist_fn

                self._diag_fn = make_diag_fn(model, cfg, histograms=cfg.do_histogram_summaries)
                self._param_hist_fn = make_param_hist_fn()
            # train-batch diagnostics, like the reference's merged train
            # summary (:719-736)
            t_scalars, t_grids, t_hists = self._diag_fn(
                *self._to_device(tx_, ts_, shard=False), gen)
            t_scalars = {k: float(v) for k, v in t_scalars.items()}
            writer.scalars(t_scalars, step)
            scalars.update(t_scalars)

        if cfg.do_image_summaries:
            from phiseg_tpu_torch.utils.diagnostics import first_conv_kernel
            from phiseg_tpu_torch.utils.image_grid import batch_to_grid, kernels_to_grid

            if not hasattr(self, "_img_sampler"):
                self._img_sampler = make_sample_fn(model, 1)
            vx_d, vs_d = self._to_device(vx, vs, shard=False)
            gen_seg = self._img_sampler(vx_d, gen)[0].argmax(-1).cpu().numpy()
            _, v_grids, _ = self._diag_fn(vx_d, vs_d, gen)

            def lm(a):
                return batch_to_grid(a, "labelmap", cfg.nlabels)

            writer.image("train_x_inp", batch_to_grid(np.asarray(tx_), "standardize"), step)
            writer.image("train_s_inp", lm(np.asarray(ts_)), step)
            writer.image("val_x_inp", batch_to_grid(np.asarray(vx), "standardize"), step)
            writer.image("val_s_inp", lm(np.asarray(vs)), step)
            writer.image("generated_seg", lm(gen_seg), step)
            writer.image("generated_x_in", batch_to_grid(np.asarray(vx), "standardize"), step)
            for prefix, grids in (("train", t_grids), ("val", v_grids)):
                for name, g in grids.items():
                    writer.image(f"{prefix}_{name}", lm(g), step)
            # first-layer kernel grid (ref put_kernels_on_grid viz)
            kname, kernel = first_conv_kernel(model)
            if kernel is not None:
                writer.image(f"kernels/{kname}", kernels_to_grid(kernel), step)

        if cfg.do_histogram_summaries:
            for name, h in t_hists.items():
                writer.histogram_summary(name, h, step)
            for name, h in self._param_hist_fn(model).items():
                writer.histogram_summary(name, h, step)

        writer.flush()
        write_metrics_jsonl(self.metrics_path, step, scalars)
        return scalars
