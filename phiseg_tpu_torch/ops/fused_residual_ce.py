"""Fused multi-level residual cross-entropy: the CUDA kernel pair and its
plain PyTorch version (port of phiseg_tpu/ops/fused_residual_ce.py).

The PHiSeg objective evaluates softmax CE on the RESIDUALLY ACCUMULATED
per-level logits: level i's logits are sum_{j>=i} s_out[j] (ref
phiseg/phiseg_model.py:241-262). The kernels (csrc/fused_residual_ce.cu)
read each level once and keep the accumulation in registers:

  K1  forward:  (L,B,H,W,C) logits + (B,H,W,C) one-hot -> (L,) per-level
      mean-over-batch of the pixel-summed CE;
  K2  backward: all L logit gradients in one pass, in the logits' dtype;
  K3  data parallel (`fused_residual_ce_dp`): K1/K2 on each rank's local
      batch shard, and an all_reduce averages the (L,) result over the ranks.
      It has no kernel of its own, as the TPU's has no Pallas body: there the
      pmean is a collective that XLA lowers outside any kernel.

`fused_residual_ce` launches them for CUDA tensors and uses the plain
version, `residual_ce_plain`, for CPU tensors only: a CUDA tensor gets the
kernel or an error, never a silent fallback. The library is built with nvcc
for sm_90a into `_build/` at the first launch and bound with ctypes, so
importing this module needs neither nvcc nor a card.
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
from typing import Dict, Optional, Sequence

import torch

from phiseg_tpu_torch.nn.losses import multinoulli_loss_with_logits

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_residual_ce.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_LEVELS = 8   # kMaxLevels in the source
MAX_CLASSES = 4  # the NC instantiations in the source
_THREADS = 256   # kThreads in the source
_BLOCKS_PER_SM = 4

# Launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one where it launches its kernel and nowhere else.
LAUNCHES: Dict[str, int] = {"fused_residual_ce_fwd": 0, "fused_residual_ce_bwd": 0,
                            "fused_residual_ce_dp": 0}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
BUILD_INFO: Dict[str, object] = {}


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
    raise RuntimeError("nvcc not found: the fused residual-CE kernels need the CUDA toolkit")


def build() -> Path:
    """Compile csrc/fused_residual_ce.cu into a shared library (once per
    source and flags; the file name carries their hash) and return its path.
    Fills BUILD_INFO with the seconds taken and ptxas's report."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libfused_residual_ce_{digest}.so"
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, cached=True)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0, cached=False,
                      ptxas=proc.stderr.strip())
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.frce_forward.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i32, i32, i32, i32, ptr]
            lib.frce_forward.restype = i32
            lib.frce_backward.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i32, i32, i32, i32, ptr]
            lib.frce_backward.restype = i32
            lib.frce_max_levels.argtypes, lib.frce_max_levels.restype = [], i32
            lib.frce_max_classes.argtypes, lib.frce_max_classes.restype = [], i32
            if (lib.frce_max_levels(), lib.frce_max_classes()) != (MAX_LEVELS, MAX_CLASSES):
                raise RuntimeError("csrc/fused_residual_ce.cu maxima disagree with the wrapper")
            _lib = lib
        return _lib


def _check(stacked_logits: torch.Tensor, s_oh: torch.Tensor) -> None:
    if stacked_logits.dim() != 5:
        raise ValueError(f"stacked_logits must be (L,B,H,W,C), got {tuple(stacked_logits.shape)}")
    if tuple(s_oh.shape) != tuple(stacked_logits.shape[1:]):
        raise ValueError(f"s_oh {tuple(s_oh.shape)} must be (B,H,W,C) = "
                         f"{tuple(stacked_logits.shape[1:])}")
    if not stacked_logits.is_cuda or s_oh.device != stacked_logits.device:
        raise ValueError("the fused residual-CE kernels take two tensors on one CUDA device")
    if stacked_logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"logits must be float32 or bfloat16, got {stacked_logits.dtype}")
    if s_oh.dtype != torch.float32:
        raise TypeError(f"s_oh must be float32, got {s_oh.dtype}")
    if not (stacked_logits.is_contiguous() and s_oh.is_contiguous()):
        raise ValueError("the fused residual-CE kernels take contiguous tensors")
    levels, nclass = stacked_logits.shape[0], stacked_logits.shape[-1]
    if not 1 <= levels <= MAX_LEVELS:
        raise ValueError(f"{levels} levels; the kernel takes 1..{MAX_LEVELS}")
    if not 1 <= nclass <= MAX_CLASSES:
        raise ValueError(f"{nclass} classes; the kernel takes 1..{MAX_CLASSES}")


def _num_blocks(device: torch.device, pixels: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-pixels // _THREADS), sms * _BLOCKS_PER_SM))


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def fused_residual_ce_forward(stacked_logits: torch.Tensor, s_oh: torch.Tensor) -> torch.Tensor:
    """Launch K1: (L,) per-level CE. No autograd."""
    _check(stacked_logits, s_oh)
    lib = _library()
    levels, b = stacked_logits.shape[0], stacked_logits.shape[1]
    nclass = stacked_logits.shape[-1]
    pixels = s_oh.numel() // nclass
    nblocks = _num_blocks(stacked_logits.device, pixels)
    partials = torch.empty((nblocks, levels), dtype=torch.float32, device=stacked_logits.device)
    out = torch.empty((levels,), dtype=torch.float32, device=stacked_logits.device)
    stream = torch.cuda.current_stream(stacked_logits.device).cuda_stream
    err = lib.frce_forward(stacked_logits.data_ptr(), s_oh.data_ptr(), partials.data_ptr(),
                           out.data_ptr(), levels, pixels, nclass, b,
                           int(stacked_logits.dtype == torch.bfloat16), nblocks, stream)
    _raise_on(err, "fused_residual_ce forward")
    LAUNCHES["fused_residual_ce_fwd"] += 1
    return out


def fused_residual_ce_backward(stacked_logits: torch.Tensor, s_oh: torch.Tensor,
                               g: torch.Tensor) -> torch.Tensor:
    """Launch K2: d(sum_i g_i * out_i)/d logits, in the logits' dtype."""
    _check(stacked_logits, s_oh)
    levels, b = stacked_logits.shape[0], stacked_logits.shape[1]
    g = g.to(device=stacked_logits.device, dtype=torch.float32).reshape(-1).contiguous()
    if g.numel() != levels:
        raise ValueError(f"cotangent has {g.numel()} entries for {levels} levels")
    lib = _library()
    nclass = stacked_logits.shape[-1]
    pixels = s_oh.numel() // nclass
    nblocks = _num_blocks(stacked_logits.device, pixels)
    grad = torch.empty_like(stacked_logits)
    stream = torch.cuda.current_stream(stacked_logits.device).cuda_stream
    err = lib.frce_backward(stacked_logits.data_ptr(), s_oh.data_ptr(), g.data_ptr(),
                            grad.data_ptr(), levels, pixels, nclass, b,
                            int(stacked_logits.dtype == torch.bfloat16), nblocks, stream)
    _raise_on(err, "fused_residual_ce backward")
    LAUNCHES["fused_residual_ce_bwd"] += 1
    return grad


class _FusedResidualCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stacked_logits, s_oh):
        ctx.save_for_backward(stacked_logits, s_oh)
        return fused_residual_ce_forward(stacked_logits, s_oh)

    @staticmethod
    def backward(ctx, g):
        stacked_logits, s_oh = ctx.saved_tensors
        return fused_residual_ce_backward(stacked_logits, s_oh, g), None


def fused_residual_ce(stacked_logits: torch.Tensor, s_oh: torch.Tensor) -> torch.Tensor:
    """Per-level accumulated CE losses, differentiable in the logits.

    stacked_logits: (L,B,H,W,C); s_oh: (B,H,W,C) one-hot. Returns (L,) f32
    with out[i] = mean_b sum_px CE(sum_{j>=i} logits[j], y). CUDA tensors go
    through the kernels; CPU tensors through the plain version.
    """
    if stacked_logits.device.type == "cpu":
        return residual_ce_plain(stacked_logits, s_oh)
    return _FusedResidualCE.apply(stacked_logits, s_oh)


def fused_residual_ce_dp(stacked_logits: torch.Tensor, s_oh: torch.Tensor, mesh) -> torch.Tensor:
    """K3: the per-level CE of the GLOBAL batch on every rank (port of
    phiseg_tpu/ops/fused_residual_ce.py:191-215).

    stacked_logits (L, B/N, H, W, C) and s_oh (B/N, H, W, C) are this rank's
    shard. K1/K2 run on it (the plain version for CPU tensors), and the mean
    over the ranks of the local (L,) result is the global-batch mean, since
    the shards are equal. The all_reduce is differentiable: its backward
    all-reduces the cotangent (parallel/mesh.py), and the train step's
    gradient averaging divides by the world size once.
    """
    out = mesh.mean(fused_residual_ce(stacked_logits, s_oh))
    if stacked_logits.is_cuda:
        LAUNCHES["fused_residual_ce_dp"] += 1
    return out
