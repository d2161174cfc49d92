"""Multi-criterion checkpoint manager (port of phiseg_tpu/engine/checkpoint.py:26-282).

Equivalent of the reference's five tf.train.Savers (phiseg/phiseg_model.py:
143-148: rolling latest + best val-loss / Dice / GED / NCC, saved on metric
improvement :638-660, selected by tag at load :505-525) and the auto-resume
scan (:821-848). The file stems are the JAX package's: latest ->
model.ckpt-{step}, best_dice -> model_best_dice.ckpt-{step}, ...

The format is the port's own: `torch.save` of a dict of tensors, ints,
floats, strings, lists and dicts, read back with
`torch.load(..., weights_only=True)`, in `.pt` files:
  model      the model's state_dict, batch-norm running statistics included;
  optimizer  the optimiser's state_dict (Adam's moments and step counts);
  step       the train state's step counter;
  generator  the trainer's torch.Generator state (a uint8 tensor), or None.

`load_tag` also reads the checkpoints that phiseg_tpu writes in its log
dirs, `model*.ckpt-<step>.msgpack` (flax msgpack of the whole TrainState),
through engine/msgpack_reader.py and convert.flax_train_state_to_port, so
the Trainer resumes a run that phiseg_tpu trained. A CheckpointManager
writes, lists, prunes and archives `.pt` files only: the `.msgpack` files
of such a log dir stay as they are.

A save publishes atomically (tmp + os.replace). The port's train step updates
the parameters IN PLACE, where a JAX state is immutable, so every save works
from a host copy taken when it is called (`host_snapshot`): an async write
never serialises a later step's weights.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import queue
import re
import shutil
import threading
import time
import weakref
from typing import Any, Optional, Tuple

import torch

TAGS = ("latest", "best_loss", "best_dice", "best_ged", "best_ncc", "archive")

_TAG_PREFIX = {
    "latest": "model.ckpt",
    "best_loss": "model_best_loss.ckpt",
    "best_dice": "model_best_dice.ckpt",
    "best_ged": "model_best_ged.ckpt",
    "best_ncc": "model_best_ncc.ckpt",
    "archive": "model_archive.ckpt",
}
SUFFIX = ".pt"
JAX_SUFFIX = ".msgpack"  # phiseg_tpu's checkpoints (phiseg_tpu/engine/checkpoint.py:85-86)


def list_steps(log_dir: str, tag: str, suffix: str = SUFFIX):
    """The sorted steps of `tag`'s checkpoints in log_dir with `suffix`."""
    prefix = _TAG_PREFIX[tag]
    pat = re.compile(re.escape(prefix) + r"-(\d+)" + re.escape(suffix) + "$")
    steps = []
    for p in glob.glob(os.path.join(log_dir, f"{prefix}-*{suffix}")):
        m = pat.search(os.path.basename(p))
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def _host_copy(obj: Any) -> Any:
    """obj with every tensor copied to the host (a copy even of a CPU
    tensor), containers rebuilt, everything else as is."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


@dataclasses.dataclass(eq=False)
class HostState:
    """A host copy of a train state at one step: what a checkpoint holds."""

    model: dict
    optimizer: dict
    step: int
    generator: Optional[torch.Tensor] = None

    def to_dict(self) -> dict:
        return {"model": self.model, "optimizer": self.optimizer, "step": int(self.step),
                "generator": self.generator}


def host_snapshot(state, generator: Optional[torch.Generator] = None) -> HostState:
    """Copy a TrainState (and the generator's state) to the host now."""
    return HostState(model=_host_copy(state.model.state_dict()),
                     optimizer=_host_copy(state.optimizer.state_dict()),
                     step=int(state.step),
                     generator=None if generator is None else generator.get_state().clone())


class CheckpointManager:
    def __init__(self, log_dir: str, keep: int = 2, keep_latest: int = 1,
                 archive_every_hours: float | None = 3.0, async_writes: bool = False):
        """archive_every_hours: time-based archive saves that are NEVER
        pruned (the reference's keep_checkpoint_every_n_hours=3,
        phiseg_model.py:144); None disables. The clock starts at the newest
        archive already in log_dir.

        async_writes: write on one background thread, in submission order,
        so the training loop does not wait for the disk. wait() drains the
        queue (restore() calls it); close() drains it and joins the thread.
        An error of the writer surfaces on the next save(), wait() or
        close()."""
        self.log_dir = log_dir
        self.keep = keep
        self.keep_latest = keep_latest
        self.archive_every_hours = archive_every_hours
        self._async = async_writes
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._worker_error: Optional[BaseException] = None
        # (step, weakref to the HostState, path) of the last real write: the
        # same snapshot saved under another tag at that step is hardlinked
        # instead of written again. A weak reference, so the manager never
        # keeps a snapshot alive past its caller's own reference.
        self._last_write = None
        os.makedirs(log_dir, exist_ok=True)
        mtimes = [os.path.getmtime(p) for p in
                  glob.glob(os.path.join(log_dir, f"{_TAG_PREFIX['archive']}-*{SUFFIX}"))]
        self._last_archive_time = max(mtimes) if mtimes else time.time()

    # -- paths ---------------------------------------------------------------

    def _path(self, tag: str, step: int) -> str:
        return os.path.join(self.log_dir, f"{_TAG_PREFIX[tag]}-{step}{SUFFIX}")

    def _list_steps(self, tag: str):
        return list_steps(self.log_dir, tag)

    def latest_step(self, tag: str = "latest") -> Optional[int]:
        """Highest saved step of a tag (ref get_latest_model_checkpoint_path);
        pending async writes count."""
        if self._queue is not None:
            self._queue.join()
        steps = self._list_steps(tag)
        return steps[-1] if steps else None

    def has_checkpoint(self, tag: str = "latest") -> bool:
        return self.latest_step(tag) is not None

    # -- save ------------------------------------------------------------------

    def save(self, state, tag: str = "latest", step: Optional[int] = None) -> str:
        """Save a TrainState (copied to the host now) or a HostState under
        `tag` at `step` (default: the state's own step). Returns the path."""
        if tag not in TAGS:
            raise ValueError(f"unknown checkpoint tag: {tag!r} (known: {TAGS})")
        if not isinstance(state, HostState):
            state = host_snapshot(state)
        if step is None:
            step = int(state.step)
        if self._async:
            self._ensure_worker()
            self._raise_worker_error()
            self._queue.put((state, tag, step))
            return self._path(tag, step)
        return self._save_sync(state, tag, step)

    def _raise_worker_error(self):
        if self._worker_error is not None:
            err, self._worker_error = self._worker_error, None
            raise err

    def _ensure_worker(self):
        if self._worker is not None:
            return
        self._queue = queue.Queue()

        def run():
            while True:
                item = self._queue.get()
                try:
                    if item is None:
                        return
                    if callable(item):
                        item()  # a submit()-ed task
                    else:
                        self._save_sync(*item)
                except Exception as e:  # noqa: BLE001 -- surfaced on the next call
                    self._worker_error = e
                finally:
                    self._queue.task_done()

        self._worker = threading.Thread(target=run, daemon=True, name="ckpt-writer")
        self._worker.start()

    def submit(self, fn) -> None:
        """Run fn AFTER every write queued before it has published
        (immediately in sync mode): a record such as the trainer's
        best_metrics.json never claims checkpoints that were still pending
        when the process died."""
        if self._async:
            self._ensure_worker()
            self._queue.put(fn)
        else:
            fn()

    def wait(self):
        """Drain pending async writes; re-raise a writer error."""
        if self._queue is not None:
            self._queue.join()
        self._raise_worker_error()

    def close(self):
        """Drain the queue, join the writer thread, re-raise a writer error.
        Idempotent; a later save starts a new writer."""
        if self._worker is not None:
            self._queue.put(None)
            self._queue.join()
            self._worker.join()
            self._worker = None
            self._queue = None
        self._raise_worker_error()

    def _save_sync(self, state: HostState, tag: str, step: int) -> str:
        path = self._path(tag, step)
        tmp = path + ".tmp"
        last = self._last_write
        if (last is not None and last[0] == step and last[1]() is state
                and os.path.exists(last[2]) and last[2] != path):
            # the same snapshot at the same step under another tag: share the
            # file (never mutated in place, so shared inodes are safe)
            if os.path.exists(tmp):
                os.remove(tmp)
            try:
                os.link(last[2], tmp)
            except OSError:
                shutil.copyfile(last[2], tmp)
        else:
            torch.save(state.to_dict(), tmp)
            self._last_write = (step, weakref.ref(state), path)
        os.replace(tmp, path)  # atomic publish

        if tag != "archive":  # archives are permanent
            keep = self.keep_latest if tag == "latest" else self.keep
            for old in self._list_steps(tag)[:-keep]:
                try:
                    os.remove(self._path(tag, old))
                except OSError:
                    pass
        return path

    def maybe_archive(self, state) -> Optional[str]:
        """Save an unpruned archive checkpoint if archive_every_hours has
        passed since the last one. Returns its path or None."""
        if self.archive_every_hours is None:
            return None
        now = time.time()
        if now - self._last_archive_time < self.archive_every_hours * 3600.0:
            return None
        self._last_archive_time = now
        return self.save(state, "archive")

    # -- restore ---------------------------------------------------------------

    def read(self, tag: str = "latest", step: Optional[int] = None,
             map_location="cpu") -> Tuple[dict, int]:
        """The checkpoint dict of `tag` at `step` (default: the newest) and
        its step. Pending async writes are drained first."""
        self.wait()
        if tag not in TAGS:
            raise ValueError(f"unknown checkpoint tag: {tag!r} (known: {TAGS})")
        if step is None:
            step = self.latest_step(tag)
            if step is None:
                raise FileNotFoundError(f"no '{tag}' checkpoint in {self.log_dir}")
        return torch.load(self._path(tag, step), map_location=map_location,
                          weights_only=True), step

    def restore(self, state, tag: str = "latest", step: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        """Load a checkpoint into the TrainState `state` in place (model,
        optimiser, step) and, if given, into `generator`. Returns
        (state, step of the file)."""
        # Read to the host: load_state_dict moves the model's tensors and
        # Adam's moments to their parameters' device, while Adam's step
        # counts stay on the host, where torch keeps them.
        ckpt, step = self.read(tag, step)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        if generator is not None and ckpt.get("generator") is not None:
            generator.set_state(ckpt["generator"])
        return state, step


def newest_checkpoint(log_dir: str, tag: str = "latest") -> Optional[Tuple[int, str]]:
    """(step, suffix) of the newest checkpoint of `tag` in log_dir, the
    port's `.pt` or phiseg_tpu's `.msgpack`; None if neither holds the tag.
    Raises if that step exists in both formats."""
    if tag not in TAGS:
        raise ValueError(f"unknown checkpoint tag: {tag!r} (known: {TAGS})")
    pt, jx = list_steps(log_dir, tag), list_steps(log_dir, tag, JAX_SUFFIX)
    if not pt and not jx:
        return None
    step = max(pt + jx)
    if step in pt and step in jx:
        raise ValueError(f"'{tag}' at step {step} is in {log_dir} as both {SUFFIX} and "
                         f"{JAX_SUFFIX}; remove one")
    return step, SUFFIX if step in pt else JAX_SUFFIX


def load_tag(state, log_dir: str, tag: str = "latest",
             generator: Optional[torch.Generator] = None):
    """Load the newest checkpoint of `tag` in log_dir into the TrainState
    `state` in place, from the port's `.pt` or phiseg_tpu's `.msgpack`,
    whichever holds the newer step (`newest_checkpoint`), and a `.pt`'s
    generator state into `generator` if one is given (a `.msgpack` holds
    none). Raises if that step exists in both formats, or if neither holds
    the tag. Returns (state, step)."""
    found = newest_checkpoint(log_dir, tag)
    if found is None:
        raise FileNotFoundError(f"no '{tag}' checkpoint in {log_dir}")
    step, suffix = found
    if suffix == SUFFIX:
        return CheckpointManager(log_dir).restore(state, tag, step, generator=generator)
    from phiseg_tpu_torch.convert import flax_train_state_to_port
    from phiseg_tpu_torch.engine.msgpack_reader import msgpack_restore

    path = os.path.join(log_dir, f"{_TAG_PREFIX[tag]}-{step}{JAX_SUFFIX}")
    with open(path, "rb") as f:
        flax_train_state_to_port(msgpack_restore(f.read()), state)
    return state, step


def write_metrics_jsonl(path: str, step: int, metrics: dict) -> None:
    """Append one structured metrics record (observability sidecar)."""
    rec = {"step": int(step)}
    for k, v in metrics.items():
        try:
            rec[k] = float(v)
        except (TypeError, ValueError):
            rec[k] = v
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
