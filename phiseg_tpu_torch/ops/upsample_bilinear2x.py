"""x2 bilinear upsample: the CUDA kernel pair and its plain PyTorch version.

The function is jax.image.resize's "bilinear" at an integer factor of 2
(phiseg_tpu/nn/layers.py upsample_bilinear), which is
F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False):
half-pixel centres, the edge clamped. Every input pixel owns the 2x2 output
quad of a fixed 3x3 stencil. The kernels (csrc/upsample_bilinear2x.cu)
replace PyTorch's resize on the card, whose NCHW kernel loops serially over
N*C in each thread; they replace no TPU kernel, as the JAX package leaves
the resize to XLA.

  forward:  (N,C,H,W) -> (N,C,2H,2W) in the input's memory format, summed in
            F.interpolate's order in f32 (f64 for f64) with the fused
            multiply-adds of PyTorch's own kernels, rounded once: on the
            card, F.interpolate's result bit for bit;
  backward: a gather, each input pixel summing its 4x4 output neighbourhood
            with per-axis weights (1/4, 3/4, 3/4, 1/4), in f32, rounded once.

Each kernel has an instantiation for NCHW planes and one for pixel-major
(channels_last) rows; the input's memory format chooses, as it chooses the
output's in F.interpolate (`memory_format`). `upsample_bilinear2x` launches
them for CUDA tensors and takes the plain versions (`upsample2x_plain`,
`upsample2x_gather_plain`) for CPU tensors only: a CUDA tensor gets the
kernel or an error, never a fallback. The library is built with nvcc for
sm_90a into `_build/` at the first launch (ops/cuda_build.py) and bound
with ctypes, so importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Dict, Optional

import torch
from torch.autograd.function import once_differentiable

from phiseg_tpu_torch.ops import cuda_build

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "upsample_bilinear2x.cu"
DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}  # the source's dtype codes
MAX_GROUP = 2 ** 31 - 1  # output elements of one plane or image: the kernels' 32-bit offsets

# Launches of each kernel since the last reset_launch_counts(); the wrapper
# adds one where it launches its kernel and nowhere else.
LAUNCHES: Dict[str, int] = {"upsample2x_fwd": 0, "upsample2x_bwd": 0}
BUILD_INFO: Dict[str, object] = {}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _acc(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.stack([even, odd], dim + 1).flatten(dim, dim + 1)


def _lerp2x(v: torch.Tensor, dim: int) -> torch.Tensor:
    """x2 along `dim`: out[2k] = 0.25 v[k-1] + 0.75 v[k] (at k = 0, as
    F.interpolate weighs it, 1 v[0] + 0 v[1]) and out[2k+1] = 0.75 v[k] +
    0.25 v[k+1], v's edge replicated."""
    n = v.shape[dim]
    lo = torch.cat([v.narrow(dim, 0, 1), v.narrow(dim, 0, n - 1)], dim)  # v[k-1]
    hi = torch.cat([v.narrow(dim, 1, n - 1), v.narrow(dim, n - 1, 1)], dim)  # v[k+1]
    shape = [1] * v.dim()
    shape[dim] = n
    first = (torch.arange(n, device=v.device) == 0).view(shape)
    w0 = torch.where(first, 1.0, 0.25).to(v.dtype)
    w1 = torch.where(first, 0.0, 0.75).to(v.dtype)
    even = w0 * torch.where(first, v, lo) + w1 * torch.where(first, hi, v)
    return _interleave(even, 0.75 * v + 0.25 * hi, dim)


def _gather2x(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The adjoint of `_lerp2x` along `dim`: v[k] = 0.25 (g[2k-1] + g[2k+2])
    + 0.75 (g[2k] + g[2k+1]), g's indices clamped to its edge."""
    pairs = g.unflatten(dim, (g.shape[dim] // 2, 2))
    even, odd = pairs.select(dim + 1, 0), pairs.select(dim + 1, 1)
    n = even.shape[dim]
    prev = torch.cat([even.narrow(dim, 0, 1), odd.narrow(dim, 0, n - 1)], dim)  # g[2k-1]
    nxt = torch.cat([even.narrow(dim, 1, n - 1), odd.narrow(dim, n - 1, 1)], dim)  # g[2k+2]
    return 0.25 * (prev + nxt) + 0.75 * (even + odd)


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    """The forward in plain PyTorch: (N,C,H,W) -> (N,C,2H,2W), along W then
    along H (F.interpolate's h0 * (w0 a + w1 b) + h1 * (w0 c + w1 d)), in
    f32 (f64 for f64), rounded once to x's dtype; NCHW-contiguous."""
    return _lerp2x(_lerp2x(_acc(x), 3), 2).to(x.dtype)


def upsample2x_gather_plain(g: torch.Tensor) -> torch.Tensor:
    """The backward in plain PyTorch: the output's gradient (N,C,2H,2W) ->
    the input's (N,C,H,W), gathered along W then along H in f32 (f64 for
    f64), rounded once to g's dtype; NCHW-contiguous."""
    return _gather2x(_gather2x(_acc(g), 3), 2).to(g.dtype)


# ---------------------------------------------------------------------------
# Checks and layout
# ---------------------------------------------------------------------------


def memory_format(x: torch.Tensor) -> torch.memory_format:
    """The memory format F.interpolate gives its output, which is x's
    suggested format (c10's is_channels_last_strides_2d for 4-D sizes and
    strides): channels_last when the strides order C, W, H, N from the
    innermost, ties of size-1 dimensions resolved as c10 resolves them, else
    contiguous."""
    sizes, strides = x.shape, x.stride()
    if strides[1] == 0:
        return torch.contiguous_format
    least = 0
    for d in (1, 3, 2, 0):
        if sizes[d] == 0 or strides[d] < least or (d == 0 and least == strides[1]):
            return torch.contiguous_format
        least = strides[d] * max(sizes[d], 1)
    return torch.channels_last


def _check(x: torch.Tensor) -> torch.memory_format:
    """Raise on what the op does not take; else x's `memory_format`."""
    if x.dtype not in DTYPES:
        raise TypeError(f"upsample_bilinear2x takes bfloat16, float32 or float64, not {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"upsample_bilinear2x takes (N,C,H,W), got {tuple(x.shape)}")
    fmt = memory_format(x)
    _, c, h, w = x.shape
    if x.is_cuda and 4 * h * w * (c if fmt == torch.channels_last else 1) > MAX_GROUP:
        raise ValueError(f"{tuple(x.shape)}: the kernels take at most {MAX_GROUP} (2^31 - 1) "
                         "output elements a plane (NCHW) or an image (channels_last)")
    return fmt


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(cuda_build.build(SOURCE, "upsample_bilinear2x", BUILD_INFO)))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            for name in ("bilinear2x_forward", "bilinear2x_backward"):
                fn = getattr(lib, name)
                fn.argtypes = [ptr, ptr, i64, i32, i32, i32, i32, i32, ptr]
                fn.restype = i32
            lib.bilinear2x_width.argtypes = [ptr, ptr, i32, i32, i32, i32]
            lib.bilinear2x_width.restype = i32
            _lib = lib
        return _lib


def _geometry(t: torch.Tensor, fmt: torch.memory_format):
    """(groups, planes, H, W, C) as the C entry points take them, for an
    input-sized (N,C,H,W) tensor laid out in `fmt`."""
    n, c, h, w = t.shape
    if fmt == torch.channels_last:
        return n, 0, h, w, c
    return n * c, 1, h, w, 1


def width(small: torch.Tensor, big: torch.Tensor, fmt: torch.memory_format) -> int:
    """The instantiation a launch on these tensors takes: input columns
    (NCHW planes) or channels (channels_last) a thread, 1 for the scalar
    one. `small` is the input-sized tensor, `big` the output-sized one."""
    _, planes, _, w, c = _geometry(small, fmt)
    return _library().bilinear2x_width(small.data_ptr(), big.data_ptr(), planes, w, c,
                                       DTYPES[small.dtype])


def _launch(forward: bool, src: torch.Tensor, fmt: torch.memory_format) -> torch.Tensor:
    """One kernel on a CUDA tensor laid out in `fmt`: the forward from x,
    or the backward from the output's gradient; the result in `fmt`."""
    n, c, h, w = src.shape
    shape = (n, c, 2 * h, 2 * w) if forward else (n, c, h // 2, w // 2)
    dst = torch.empty(shape, dtype=src.dtype, device=src.device, memory_format=fmt)
    if dst.numel() == 0:
        return dst
    small = dst if not forward else src
    if not forward and fmt == torch.contiguous_format and src.data_ptr() % (2 * src.element_size()):
        src = src.clone()  # a planes thread reads its output columns in pairs
    groups, planes, hh, ww, cc = _geometry(small, fmt)
    lib = _library()
    fn = lib.bilinear2x_forward if forward else lib.bilinear2x_backward
    err = fn(src.data_ptr(), dst.data_ptr(), groups, planes, hh, ww, cc, DTYPES[src.dtype],
             torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"upsample_bilinear2x {'forward' if forward else 'backward'} launch "
                           f"failed: CUDA error {err}")
    LAUNCHES["upsample2x_fwd" if forward else "upsample2x_bwd"] += 1
    return dst


def _in_format(t: torch.Tensor, fmt: torch.memory_format) -> torch.Tensor:
    """t with `fmt`'s strides, also where t's sizes make both formats
    contiguous (C = 1), in which `contiguous` would keep t's."""
    return torch.empty_like(t, memory_format=fmt).copy_(t)


def _forward(x: torch.Tensor, fmt: torch.memory_format) -> torch.Tensor:
    if x.is_cuda:
        return _launch(True, x.contiguous(memory_format=fmt), fmt)
    return _in_format(upsample2x_plain(x), fmt)


def _backward(g: torch.Tensor, fmt: torch.memory_format) -> torch.Tensor:
    if g.is_cuda:
        return _launch(False, g.contiguous(memory_format=fmt), fmt)
    return _in_format(upsample2x_gather_plain(g), fmt)


class _Upsample2x(torch.autograd.Function):
    """The forward kernel, the gather kernel as its backward (the plain
    versions on the CPU); both in the input's memory format."""

    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return _forward(x, fmt)

    @staticmethod
    @once_differentiable  # the gather kernel has no backward of its own
    def backward(ctx, g):
        return _backward(g, ctx.fmt), None


def upsample_bilinear2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 upsample of NCHW (bf16, f32 or f64), differentiable:
    F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False),
    to the bit on the card (the kernels) and to a few ulps of the terms'
    magnitude on the CPU (the plain versions, which round every product), in
    the memory format F.interpolate gives. Strides other than
    NCHW-contiguous or channels_last are made contiguous in that format
    first."""
    return _Upsample2x.apply(x, _check(x))
