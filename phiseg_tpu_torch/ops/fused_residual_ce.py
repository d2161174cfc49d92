"""Fused multi-level residual cross-entropy: the CUDA kernel pair and its
plain PyTorch version (port of phiseg_tpu/ops/fused_residual_ce.py).

The PHiSeg objective evaluates softmax CE on the RESIDUALLY ACCUMULATED
per-level logits: level i's logits are sum_{j>=i} s_out[j] (ref
phiseg/phiseg_model.py:241-262). The kernels (csrc/fused_residual_ce.cu)
read each level once and keep the accumulation in registers:

  K1  forward:  L level logits + (B,H,W,C) one-hot -> (L,) per-level
      mean-over-batch of the pixel-summed CE, in one launch;
  K2  backward: all L logit gradients in one pass, in the logits' dtype;
  K3  data parallel (`fused_residual_ce_dp`): K1/K2 on each rank's local
      batch shard, and an all_reduce averages the (L,) result over the ranks.
      It has no kernel of its own, as the TPU's has no Pallas body: there the
      pmean is a collective that XLA lowers outside any kernel.

The logits come in either of two forms: the JAX package's one (L,B,H,W,C)
tensor, or a sequence of L (B,H,W,C) tensors, which is what the model hands
out (NHWC views of its NCHW-shaped level tensors). The kernels take L level
pointers and read the levels in place in either memory layout, NCHW planes
or pixel-major (B,H,W,C) rows (`_levels_nchw`): the model's levels, and each
level of the stacked form, reach them without a copy.

`fused_residual_ce` launches them for CUDA tensors and uses the plain
version, `residual_ce_plain`, for CPU tensors only: a CUDA tensor gets the
kernel or an error, never a silent fallback. Each kernel has a vector
instantiation and a scalar one for planes or pointers the vector accesses
cannot take: K1's takes 4 pixels a thread with 16-byte loads
(`vector_kernel_fits` chooses), K2's 2 pixels a thread with accesses of up to
16 bytes whose width is fixed at compile time (`backward_vector_fits`
chooses). The library is built with nvcc for sm_90a into `_build/` at the
first launch and bound with ctypes, so importing this module needs neither
nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import torch

from phiseg_tpu_torch.nn.losses import multinoulli_loss_with_logits

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_residual_ce.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_LEVELS = 8   # kMaxLevels in the source
MAX_CLASSES = 4  # the NC instantiations in the source
VEC = 4          # kVec in the source: pixels a thread of K1's vector kernel
BWD_PX = 2       # kBwdPx in the source: pixels a thread of K2's vector kernel
MAX_BATCH = 65535         # kMaxBatch in the source: K2's images, on the grid's y
MAX_IMAGE = 2 ** 31 - 1   # K2's 32-bit offsets inside an image: C*H*W elements at most
_THREADS = 256   # kThreads in the source
_BLOCKS_PER_SM = 8

# Launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one where it launches its kernel and nowhere else.
LAUNCHES: Dict[str, int] = {"fused_residual_ce_fwd": 0, "fused_residual_ce_bwd": 0,
                            "fused_residual_ce_dp": 0}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
BUILD_INFO: Dict[str, object] = {}
# K1's ticket counter, one per device: zeroed once here, and back at 0 after
# every launch (the kernel's last block wraps it).
_tickets: Dict[int, torch.Tensor] = {}

Logits = Union[torch.Tensor, Sequence[torch.Tensor]]


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain version (the loop of phiseg_tpu/engine/objective.py:53-61)
# ---------------------------------------------------------------------------


def residual_ce_plain(s_out_list: Sequence[torch.Tensor], s_oh: torch.Tensor) -> torch.Tensor:
    """(L,) per-level CE of the residually accumulated logits, level order."""
    levels = len(s_out_list)
    per_level = [None] * levels
    s_accum = None
    for i in reversed(range(levels)):
        s_accum = s_out_list[i] if s_accum is None else s_accum + s_out_list[i]
        per_level[i] = multinoulli_loss_with_logits(s_oh, s_accum)
    return torch.stack(per_level)


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def build(source: Path = SOURCE, stem: str = "fused_residual_ce",
          info: Optional[Dict[str, object]] = None) -> Path:
    """Compile a csrc/ source (by default K1/K2's) into the shared library
    `_build/lib<stem>_<hash>.so` (once per source and flags; the hash is of
    both) and return its path. Fills `info` (default BUILD_INFO) with the
    seconds taken and ptxas's report."""
    info = BUILD_INFO if info is None else info
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{stem}_{digest}.so"
    if out.exists():
        info.update(path=str(out), seconds=0.0, cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    info.update(path=str(out), seconds=time.perf_counter() - t0, cached=False,
                ptxas=proc.stderr.strip())
    return out


def bind(path: Union[str, Path]) -> ctypes.CDLL:
    """Load a build of the kernel library and declare its C entry points."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.frce_forward.argtypes = [ptrs, i32, i32, ptr, ptr, ptr, ptr, i64, i64, i32, i32, i32, i32,
                                 i32, ptr]
    lib.frce_forward.restype = i32
    lib.frce_backward.argtypes = [ptrs, ptrs, i32, i32, ptr, ptr, i64, i64, i32, i32, i32, i32, ptr]
    lib.frce_backward.restype = i32
    for name in ("frce_max_levels", "frce_max_classes", "frce_vec", "frce_bwd_px"):
        getattr(lib, name).argtypes, getattr(lib, name).restype = [], i32
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = bind(build())
            if (lib.frce_max_levels(), lib.frce_max_classes(), lib.frce_vec(),
                    lib.frce_bwd_px()) != (MAX_LEVELS, MAX_CLASSES, VEC, BWD_PX):
                raise RuntimeError("csrc/fused_residual_ce.cu constants disagree with the wrapper")
            _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# Layout and checks
# ---------------------------------------------------------------------------


def _levels_nchw(logits: Logits) -> List[torch.Tensor]:
    """The L level tensors as the kernels read them: (B,C,H,W)-shaped, all
    NCHW-contiguous (planes) or all channels-last, i.e. pixel-major rows.

    Levels already laid out so are returned as views sharing their storage:
    NHWC views of NCHW tensors, levels contiguous in NHWC (what the model's
    channels-last likelihood hands out), and each level of the stacked
    (L,B,H,W,C) form. Levels in neither layout, or in two, are copied into
    NCHW. Differentiable.
    """
    if isinstance(logits, torch.Tensor):
        if logits.dim() != 5:
            raise ValueError(f"stacked logits must be (L,B,H,W,C), got {tuple(logits.shape)}")
        levels = list(logits.permute(0, 1, 4, 2, 3).unbind(0))
    else:
        levels = []
        for t in logits:
            if t.dim() != 4:
                raise ValueError(f"each level's logits must be (B,H,W,C), got {tuple(t.shape)}")
            levels.append(t.permute(0, 3, 1, 2))
    if _planes(levels) or all(t.is_contiguous(memory_format=torch.channels_last) for t in levels):
        return levels
    return [t.contiguous() for t in levels]


def _planes(levels: Sequence[torch.Tensor]) -> bool:
    """NCHW planes (else pixel-major rows)."""
    return all(t.is_contiguous() for t in levels)


def vector_kernel_fits(hw: int, level_ptrs: Sequence[int], itemsize: int, label_ptr: int) -> bool:
    """Whether K1's vector kernel can take these tensors, else its scalar
    one runs. A vector thread reads VEC pixels of each level and class with
    one load of VEC * itemsize bytes and its labels with 16-byte loads, so
    H*W must be a multiple of VEC, every level pointer aligned to
    VEC * itemsize bytes and the labels to 16."""
    width = VEC * itemsize
    return hw % VEC == 0 and label_ptr % 16 == 0 and all(p % width == 0 for p in level_ptrs)


def _access_bytes(run: int, elem: int) -> int:
    """The widest access (16, 8 or 4 bytes) that tiles a run of `run` bytes,
    else one element an access (access_bytes in the source)."""
    return next((w for w in (16, 8, 4) if run % w == 0), elem)


def backward_vector_fits(hw: int, nclass: int, planes: bool, ptrs: Sequence[int], itemsize: int,
                         label_ptr: int) -> bool:
    """Whether K2's vector kernel can take these tensors, else its scalar one
    runs. A vector thread reads and writes BWD_PX pixels of each level per
    access run: BWD_PX elements of each class plane, or the BWD_PX * C
    elements of its pixels' rows; and its labels as the BWD_PX * C floats of
    their rows. Each run goes in accesses of one width fixed at compile time
    (`_access_bytes`), so H*W must be a multiple of BWD_PX (every run then
    starts a multiple of its own size into its tensor) and every level and
    gradient pointer in `ptrs`, and the labels, aligned to their width."""
    width = _access_bytes(BWD_PX * (1 if planes else nclass) * itemsize, itemsize)
    return (hw % BWD_PX == 0 and label_ptr % _access_bytes(BWD_PX * nclass * 4, 4) == 0
            and all(p % width == 0 for p in ptrs))


def check_backward_grid(batch: int, nclass: int, hw: int) -> None:
    """K2's grid holds the images on its y dimension and addresses each
    image's C*H*W elements with 32-bit offsets: refuse what it cannot hold."""
    if batch > MAX_BATCH:
        raise ValueError(f"batch {batch}: the backward kernel's grid holds at most {MAX_BATCH} "
                         "images")
    if nclass * hw > MAX_IMAGE:
        raise ValueError(f"an image of {nclass} x {hw} elements: the backward kernel takes at "
                         f"most {MAX_IMAGE} (2^31 - 1) elements an image")


def _check(levels: Sequence[torch.Tensor], s_oh: torch.Tensor) -> None:
    """The levels (from `_levels_nchw`) and the one-hot are what the kernels take."""
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"{len(levels)} levels; the kernel takes 1..{MAX_LEVELS}")
    first = levels[0]
    if not all(t.is_cuda and t.device == first.device for t in (*levels, s_oh)):
        raise ValueError("the fused residual-CE kernels take tensors on one CUDA device")
    if first.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != first.dtype for t in levels):
        raise TypeError(f"logits must be all float32 or all bfloat16, got "
                        f"{sorted({str(t.dtype) for t in levels})}")
    if s_oh.dtype != torch.float32:
        raise TypeError(f"s_oh must be float32, got {s_oh.dtype}")
    b, nclass, h, w = first.shape
    if any(t.shape != first.shape for t in levels) or tuple(s_oh.shape) != (b, h, w, nclass):
        raise ValueError(f"levels {[tuple(t.permute(0, 2, 3, 1).shape) for t in levels]} and "
                         f"s_oh {tuple(s_oh.shape)} must all be (B,H,W,C)")
    if not s_oh.is_contiguous():
        raise ValueError("the fused residual-CE kernels take a contiguous s_oh")
    if not 1 <= nclass <= MAX_CLASSES:
        raise ValueError(f"{nclass} classes; the kernel takes 1..{MAX_CLASSES}")


def _num_blocks(device: torch.device, groups: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-groups // _THREADS), sms * _BLOCKS_PER_SM))


def _ticket(device: torch.device) -> torch.Tensor:
    with _lib_lock:
        if device.index not in _tickets:
            _tickets[device.index] = torch.zeros(1, dtype=torch.int32, device=device)
        return _tickets[device.index]


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _pointers(tensors: Sequence[torch.Tensor]):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


# ---------------------------------------------------------------------------
# The kernel wrappers, on `_levels_nchw`'s levels
# ---------------------------------------------------------------------------


def _launch_forward(levels: Sequence[torch.Tensor], s_oh: torch.Tensor) -> torch.Tensor:
    """K1 on checked levels: (L,) per-level CE."""
    lib = _library()
    first = levels[0]
    b, nclass, h, w = first.shape
    vec = vector_kernel_fits(h * w, [t.data_ptr() for t in levels], first.element_size(),
                             s_oh.data_ptr())
    nblocks = _num_blocks(first.device, b * h * w // (VEC if vec else 1))
    partials = torch.empty((nblocks, MAX_LEVELS), dtype=torch.float32, device=first.device)
    out = torch.empty((len(levels),), dtype=torch.float32, device=first.device)
    stream = torch.cuda.current_stream(first.device).cuda_stream
    err = lib.frce_forward(_pointers(levels), len(levels), int(_planes(levels)), s_oh.data_ptr(),
                           partials.data_ptr(), _ticket(first.device).data_ptr(), out.data_ptr(),
                           h * w, b * h * w, nclass, b, int(first.dtype == torch.bfloat16),
                           int(vec), nblocks, stream)
    _raise_on(err, "fused_residual_ce forward")
    LAUNCHES["fused_residual_ce_fwd"] += 1
    return out


def _launch_backward(levels: Sequence[torch.Tensor], s_oh: torch.Tensor,
                     g: torch.Tensor) -> List[torch.Tensor]:
    """K2 on checked levels: d(sum_i g_i * out_i)/d level, one tensor per
    level in the logits' dtype and memory layout."""
    first = levels[0]
    g = g.to(device=first.device, dtype=torch.float32).reshape(-1).contiguous()
    if g.numel() != len(levels):
        raise ValueError(f"cotangent has {g.numel()} entries for {len(levels)} levels")
    b, nclass, h, w = first.shape
    check_backward_grid(b, nclass, h * w)
    lib = _library()
    planes = _planes(levels)
    shape = (len(levels), b, nclass, h, w) if planes else (len(levels), b, h, w, nclass)
    grads = torch.empty(shape, dtype=first.dtype, device=first.device)
    grads = list((grads if planes else grads.permute(0, 1, 4, 2, 3)).unbind(0))
    vec = backward_vector_fits(h * w, nclass, planes, [t.data_ptr() for t in (*levels, *grads)],
                               first.element_size(), s_oh.data_ptr())
    stream = torch.cuda.current_stream(first.device).cuda_stream
    err = lib.frce_backward(_pointers(levels), _pointers(grads), len(levels), int(planes),
                            s_oh.data_ptr(), g.data_ptr(), h * w, b * h * w, nclass, b,
                            int(first.dtype == torch.bfloat16), int(vec), stream)
    _raise_on(err, "fused_residual_ce backward")
    LAUNCHES["fused_residual_ce_bwd"] += 1
    return grads


def fused_residual_ce_forward(logits: Logits, s_oh: torch.Tensor) -> torch.Tensor:
    """Launch K1: (L,) per-level CE. No autograd. `logits` is (L,B,H,W,C)
    or a sequence of L (B,H,W,C) tensors."""
    levels = _levels_nchw(logits)
    _check(levels, s_oh)
    return _launch_forward(levels, s_oh)


def fused_residual_ce_backward(logits: Logits, s_oh: torch.Tensor, g: torch.Tensor):
    """Launch K2: d(sum_i g_i * out_i)/d logits, in the logits' dtype and in
    their form: one (L,B,H,W,C) tensor for the stacked form, else a tuple of
    L (B,H,W,C) tensors, each laid out in memory as its level."""
    levels = _levels_nchw(logits)
    _check(levels, s_oh)
    grads = [gr.permute(0, 2, 3, 1) for gr in _launch_backward(levels, s_oh, g)]
    return torch.stack(grads) if isinstance(logits, torch.Tensor) else tuple(grads)


class _FusedResidualCE(torch.autograd.Function):
    """K1 forward, K2 backward: apply(s_oh, *levels) on `_levels_nchw`'s levels."""

    @staticmethod
    def forward(ctx, s_oh, *levels):
        _check(levels, s_oh)
        ctx.save_for_backward(s_oh, *levels)
        return _launch_forward(levels, s_oh)

    @staticmethod
    def backward(ctx, g):
        s_oh, *levels = ctx.saved_tensors
        return (None, *_launch_backward(levels, s_oh, g))


def _is_cuda(logits: Logits) -> bool:
    return (logits if isinstance(logits, torch.Tensor) else logits[0]).is_cuda


def fused_residual_ce(logits: Logits, s_oh: torch.Tensor) -> torch.Tensor:
    """Per-level accumulated CE losses, differentiable in the logits.

    logits: (L,B,H,W,C), or a sequence of L (B,H,W,C) tensors; s_oh:
    (B,H,W,C) one-hot. Returns (L,) f32 with out[i] = mean_b sum_px
    CE(sum_{j>=i} logits[j], y). CUDA tensors go through the kernels; CPU
    tensors through the plain version.
    """
    if not _is_cuda(logits):
        return residual_ce_plain(logits, s_oh)
    return _FusedResidualCE.apply(s_oh, *_levels_nchw(logits))


def fused_residual_ce_dp(logits: Logits, s_oh: torch.Tensor, mesh) -> torch.Tensor:
    """K3: the per-level CE of the GLOBAL batch on every rank (port of
    phiseg_tpu/ops/fused_residual_ce.py:191-215).

    logits (either form of `fused_residual_ce`, with B/N images) and s_oh
    (B/N, H, W, C) are this rank's shard. K1/K2 run on it (the plain version
    for CPU tensors), and the mean over the ranks of the local (L,) result is
    the global-batch mean, since the shards are equal. The all_reduce is
    differentiable: its backward all-reduces the cotangent (parallel/mesh.py),
    and the train step's gradient averaging divides by the world size once.
    """
    out = mesh.mean(fused_residual_ce(logits, s_oh))
    if _is_cuda(logits):
        LAUNCHES["fused_residual_ce_dp"] += 1
    return out
