"""Data parallelism over ranks (port of phiseg_tpu/parallel/mesh.py).

JAX runs one controller over a device mesh and lets GSPMD insert the
collectives. PyTorch runs one process per rank in an explicit
`torch.distributed` process group, so what XLA does for free is written out
here and in the modules that need it:

  * the batch axis is split across ranks, parameters are replicated: each
    rank takes its contiguous slice of the identical global batch
    (`shard_array`), and the train step averages the gradients
    (`Mesh.average_gradients`, called by engine/train.py);
  * batch norm is sync-BN: under a mesh every training-mode `BatchNorm`
    all-reduces its per-channel count, sum and sum of squares
    (nn/layers.py);
  * sampling splits the SAMPLE axis: each rank decodes its share of the
    draws from the same encoder cache, and an all_reduce of a zero-filled
    buffer assembles them (engine.train.make_sample_fn with a mesh).

Only `all_reduce` and `broadcast` are used, which NCCL and gloo both take on
CUDA tensors: NCCL with one rank per card, gloo also with several ranks on
one card. `spawn_ranks` starts local ranks, the counterpart of a local mesh;
`init_distributed_from_env` joins a group that `torchrun` describes, the
counterpart of `jax.distributed.initialize`.

The differentiable all_reduce (`Mesh.all_reduce_sum`) follows
torch.distributed.nn's convention: its backward all-reduces the cotangent.
Every rank computes the same global loss, so each rank's backward yields its
share of the gradient of the SUM over ranks of that loss, and
`average_gradients` divides by the world size once.
"""

from __future__ import annotations

import dataclasses
import datetime
import io
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """`device` as a torch.device; asking for CUDA without a card raises
    instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for and no CUDA card is visible; "
            "ask for the CPU explicitly (device='cpu', --device cpu) to run there")
    return dev


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the cotangents the same way.

    This is torch.distributed.nn.functional.all_reduce, which recent torch
    releases deprecate with a FutureWarning on every call; the functional
    collectives it points to have no backward for all_reduce."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the 1-D data mesh: its process group, rank, world
    size and device."""

    group: Any
    rank: int
    world_size: int
    device: torch.device

    def _live_group(self):
        if self.group is None or not dist.is_initialized():
            raise RuntimeError("the mesh has no process group: a collective cannot run, "
                               "and nothing falls back to this rank's local data")
        return self.group

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable sum of `t` over the ranks (see the module notes)."""
        return _AllReduceSum.apply(t, self._live_group())

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable mean of `t` over the ranks."""
        return self.all_reduce_sum(t) / self.world_size

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place sum of `t` over the ranks, outside autograd."""
        dist.all_reduce(t, group=self._live_group())
        return t

    def average_gradients(self, params: Sequence[nn.Parameter]) -> None:
        """Replace every parameter's gradient by its mean over the ranks: one
        all_reduce per dtype over a flat buffer. A parameter without a
        gradient contributes zeros, so every rank reduces the same sizes."""
        by_dtype = {}
        for p in params:
            by_dtype.setdefault(p.dtype, []).append(p)
        for ps in by_dtype.values():
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
            flat = torch.cat([g.reshape(-1) for g in grads])
            self.all_reduce_(flat)
            flat.div_(self.world_size)
            offset = 0
            for p in ps:
                n = p.numel()
                p.grad = flat[offset:offset + n].view_as(p)
                offset += n

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """In-place copy of rank 0's `t` to every rank, outside autograd. The
        other ranks block until rank 0 makes the call."""
        group = self._live_group()
        dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
        return t

    def broadcast_module(self, module: nn.Module) -> None:
        """Copy rank 0's parameters and buffers to every rank."""
        group = self._live_group()
        src = dist.get_global_rank(group, 0)
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=src, group=group)


def _backend_for(device: DeviceLike) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(rank: int, world_size: int, init_method: str,
                     backend: Optional[str] = None, device: DeviceLike = "cuda",
                     timeout_s: float = 1800.0) -> None:
    """Join a process group of `world_size` ranks at `init_method`
    (`tcp://localhost:<port>` for local ranks). The backend is NCCL for CUDA
    and gloo for the CPU unless given."""
    dist.init_process_group(backend or _backend_for(device), init_method=init_method,
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def init_distributed_from_env(backend: Optional[str] = None,
                              device: DeviceLike = "cuda") -> None:
    """Join the group `torchrun` describes in RANK, WORLD_SIZE, MASTER_ADDR
    and MASTER_PORT (the counterpart of jax.distributed.initialize)."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed needs torchrun's environment; {missing} unset")
    dist.init_process_group(backend or _backend_for(device), init_method="env://")


def make_mesh(num_devices: Optional[int] = None, device: DeviceLike = "cuda") -> Mesh:
    """This rank's mesh over the default process group, one rank per device.

    `device` "cuda" picks cuda:LOCAL_RANK (rank modulo the card count when
    unset); a device with an index is taken as given, so that several gloo
    ranks can share one card; "cpu" is the CPU. Asking for more devices than
    the group has ranks raises ValueError, as the JAX mesh does.
    """
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed or "
                           "init_distributed_from_env first")
    world = dist.get_world_size()
    n = world if num_devices is None else num_devices
    if n > world:
        raise ValueError(f"requested {n} devices, only {world} available")
    if n != world:
        raise ValueError(f"a mesh spans the whole process group: start {n} ranks, "
                         f"not {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), world_size=world, device=dev)


def shard_array(x, mesh: Mesh):
    """This rank's contiguous slice of the leading (batch) axis of the
    identical global batch `x` (numpy array or tensor)."""
    b = x.shape[0]
    if b % mesh.world_size:
        raise ValueError(f"global batch {b} does not split over {mesh.world_size} ranks")
    per = b // mesh.world_size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


# Every process holds the global batch and keeps its own slice, which is what
# the JAX package's multi-host path asks of each process.
shard_host_batch = shard_array


def shard_train_step(train_step, state, mesh: Mesh):
    """Prepare (train_step, state) for data-parallel execution: rank 0's
    parameters and buffers go to every rank. The step must come from
    engine.train.make_train_step(..., mesh=mesh), which averages the
    gradients between backward and the optimiser."""
    if getattr(train_step, "mesh", None) is not mesh:
        raise ValueError("build the step with make_train_step(..., mesh=mesh)")
    mesh.broadcast_module(state.model)
    return train_step, state


def make_sharded_sample_fn(model, num_samples: int, mesh: Mesh):
    """The JAX package's name (mesh.py:79-105) for
    engine.train.make_sample_fn(model, num_samples, mesh=mesh)."""
    from phiseg_tpu_torch.engine.train import make_sample_fn

    return make_sample_fn(model, num_samples, mesh=mesh)


# ---------------------------------------------------------------------------
# Local ranks
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _to_bytes(obj) -> bytes:
    # Tensors pickled by multiprocessing are shared through file descriptors,
    # which the sender must outlive; bytes need nothing of it.
    buf = io.BytesIO()
    torch.save(obj, buf)
    return buf.getvalue()


def _from_bytes(data: bytes):
    # only bytes that this module wrote, in this process or a rank it spawned
    return torch.load(io.BytesIO(data), map_location="cpu", weights_only=False)


def _rank_entry(fn, rank, world_size, init_method, backend, args, results):
    try:
        init_distributed(rank, world_size, init_method, backend=backend, timeout_s=600.0)
        out = _to_bytes(fn(*_from_bytes(args)))
    except BaseException:  # noqa: BLE001 -- reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    else:
        results.put((rank, True, out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args: tuple = (), backend: str = "gloo",
                timeout: Optional[float] = None) -> List[Any]:
    """Run fn(*args) in `world_size` fresh processes that form one process
    group on localhost, and return their results in rank order.

    fn must be importable (module level); args and results travel as
    torch.save bytes, and tensors in a result arrive on the CPU. A rank
    that raises, dies or outlives `timeout` seconds makes this raise, after
    every rank has been stopped.
    """
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, r, world_size, init_method, backend, _to_bytes(args),
                               results))
             for r in range(world_size)]
    deadline = None if timeout is None else time.monotonic() + timeout
    for p in procs:
        p.start()
    out = {}
    try:
        while len(out) < world_size:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} "
                                       f"did not finish within {timeout} s") from None
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                if dead:
                    # a rank that exits puts its result first; give the queue a moment
                    try:
                        rank, ok, payload = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(f"ranks {dead} exited without a result "
                                           f"(exit codes {[procs[r].exitcode for r in dead]})"
                                           ) from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{payload}")
            out[rank] = _from_bytes(payload)
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    return [out[r] for r in range(world_size)]
