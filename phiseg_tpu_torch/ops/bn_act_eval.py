"""Eval-mode batch norm + ReLU + the cast back: the CUDA kernel and its plain
PyTorch version.

The function is the tail of an eval-mode conv block with norm "batch" (or
"batch_bf16") and ReLU or no activation (nn/layers.py `_Normalised`): the
conv's output in bf16 or f32 is normalised in f32 with the running
statistics, `(x - mean) / sqrt(var + eps) * weight + bias`, the activation
runs, and the result is rounded once to the conv's dtype. The plain version
(`bn_act_eval_plain`) is that chain as the block runs it: an upcast,
F.batch_norm(training=False), F.relu, the cast back, four kernels an element
on the card. The kernel (csrc/bn_act_eval.cu) does it in one pass, in place,
with the rounding of cuDNN's NCHW kernel and of PyTorch's own BN kernels:
per channel invstd = rsqrt(var + eps), per element fma((x - mean) * weight,
invstd, bias), ReLU, one rounding to x's dtype.

`bn_act_eval` launches the kernel on CUDA tensors and raises on anything
else: the blocks call it only where it applies, and run the chain otherwise.
The input's memory format chooses the kernel's layout: NCHW planes
(contiguous) or channels_last pixels; other strides are made contiguous
first. The library is built with nvcc for sm_90a into `_build/` at the first
launch (ops/cuda_build.py) and bound with ctypes, so importing this module
needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from phiseg_tpu_torch.ops import cuda_build

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "bn_act_eval.cu"
DTYPES = {torch.bfloat16: 0, torch.float32: 1}  # the source's dtype codes
MAX_RUN = 2 ** 31 - 1  # elements of one plane (NCHW): the kernel's 32-bit offsets

# Launches of the kernel since the last reset_launch_counts(); the wrapper
# adds one where it launches and nowhere else.
LAUNCHES: Dict[str, int] = {"bn_act_eval": 0}
BUILD_INFO: Dict[str, object] = {}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bn_act_eval_plain(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                      weight: torch.Tensor, bias: torch.Tensor, eps: float,
                      relu: bool) -> torch.Tensor:
    """The chain in plain PyTorch: x in f32 (f64 stays f64), eval-mode
    F.batch_norm, F.relu if `relu`, rounded once to x's dtype; a new tensor."""
    y = F.batch_norm(x if x.dtype == torch.float64 else x.float(), mean, var, weight, bias,
                     training=False, eps=eps)
    return (F.relu(y) if relu else y).to(x.dtype)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(cuda_build.build(SOURCE, "bn_act_eval", BUILD_INFO)))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.bn_act_eval.argtypes = [ptr, i64, i64, i32, i32, ptr, ptr, ptr, ptr,
                                        ctypes.c_float, i32, i32, ptr]
            lib.bn_act_eval.restype = i32
            lib.bn_act_eval_width.argtypes = [ptr, i32, i64, i32, i32]
            lib.bn_act_eval_width.restype = i32
            _lib = lib
        return _lib


def layout(x: torch.Tensor):
    """(planes, groups, run) of the kernel's view of x: NCHW planes (planes
    1, N*C runs of the spatial size) when x is contiguous, channels_last
    pixels (planes 0, N*H*W runs of C) when x is channels_last (4-D) or
    channels_last_3d (5-D); None for other strides."""
    n, c = x.shape[0], x.shape[1]
    if x.is_contiguous():
        return 1, n * c, x.numel() // max(n * c, 1)
    fmt = {4: torch.channels_last, 5: torch.channels_last_3d}.get(x.dim())
    if fmt is not None and x.is_contiguous(memory_format=fmt):
        return 0, x.numel() // c, c
    return None


def width(x: torch.Tensor) -> int:
    """The instantiation a launch on x takes: elements a thread reads at
    once (8 bf16 or 4 f32), 1 for the scalar one."""
    planes, _, run = layout(x)
    return _library().bn_act_eval_width(x.data_ptr(), planes, run, x.shape[1], DTYPES[x.dtype])


def _check(x, stats) -> None:
    """Raise on what the kernel does not take."""
    if not x.is_cuda:
        raise ValueError("bn_act_eval runs on CUDA tensors; the CPU takes bn_act_eval_plain")
    if x.dtype not in DTYPES:
        raise TypeError(f"bn_act_eval takes bfloat16 or float32, not {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"bn_act_eval takes (N, C, ...), got {tuple(x.shape)}")
    c = x.shape[1]
    for name, t in zip(("running_mean", "running_var", "weight", "bias"), stats):
        if t.dtype != torch.float32 or t.shape != (c,) or t.device != x.device:
            raise ValueError(f"bn_act_eval's {name} must be ({c},) float32 on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if x.numel() // max(x.shape[0] * c, 1) > MAX_RUN:
        raise ValueError(f"{tuple(x.shape)}: the kernel takes at most {MAX_RUN} (2^31 - 1) "
                         "elements a plane")


def bn_act_eval(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor, eps: float, relu: bool) -> torch.Tensor:
    """`bn_act_eval_plain(x, ...)` by the kernel, written into x (CUDA, bf16
    or f32; f32 per-channel statistics and affine): x is returned, or, where
    its strides are neither NCHW-contiguous nor channels_last, a contiguous
    copy written in place. Not differentiable: the blocks call it without
    autograd."""
    stats = (mean, var, weight, bias)
    _check(x, stats)
    if x.numel() == 0:
        return x
    if layout(x) is None:
        x = x.contiguous()
    planes, groups, run = layout(x)
    stats = [t.contiguous() for t in stats]
    err = _library().bn_act_eval(x.data_ptr(), groups, run, planes, x.shape[1],
                                 *(t.data_ptr() for t in stats), eps, int(relu),
                                 DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_act_eval launch failed: CUDA error {err}")
    LAUNCHES["bn_act_eval"] += 1
    return x
