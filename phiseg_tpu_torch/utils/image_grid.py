"""Image-grid builders for TensorBoard summaries.

A copy of phiseg_tpu/utils/image_grid.py: the port imports nothing of the
JAX package, whose package `__init__`s import jax.

Equivalent of the reference `put_kernels_on_grid` / `prepare_tensor_for_summary`
(tfwrapper/utils.py:38-168): tile a batch of images or label maps into one
displayable grid with 'standardize' (min-max per grid) or 'labelmap'
(fixed 0..nlabels-1 range) rescaling.
"""

from __future__ import annotations

import math

import numpy as np


def batch_to_grid(batch: np.ndarray, rescale_mode: str = "standardize",
                  nlabels: int | None = None, pad: int = 1) -> np.ndarray:
    """(B,H,W) or (B,H,W,1) -> uint8 (GH, GW) grid image."""
    batch = np.asarray(batch)
    if batch.ndim == 4:
        batch = batch[..., 0]
    b, h, w = batch.shape
    cols = int(math.ceil(math.sqrt(b)))
    rows = int(math.ceil(b / cols))

    batch = batch.astype(np.float32)
    if rescale_mode == "labelmap":
        if not nlabels:
            nlabels = int(batch.max()) + 1
        batch = batch / max(nlabels - 1, 1)
    elif rescale_mode == "standardize":
        lo, hi = batch.min(), batch.max()
        batch = (batch - lo) / max(hi - lo, 1e-12)
    else:
        raise ValueError(f"unknown rescale_mode: {rescale_mode!r}")

    grid = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad), np.float32)
    for i in range(b):
        r, c = divmod(i, cols)
        grid[r * (h + pad):r * (h + pad) + h, c * (w + pad):c * (w + pad) + w] = batch[i]
    return (np.clip(grid, 0, 1) * 255).astype(np.uint8)


def kernels_to_grid(kernel: np.ndarray, upscale: int = 8) -> np.ndarray:
    """(kh, kw, cin, cout) conv kernel -> uint8 grid, one tile per output
    channel averaged over input channels, nearest-upscaled for visibility
    (the kernel-viz use of the reference's put_kernels_on_grid,
    tfwrapper/utils.py:93-168)."""
    k = np.asarray(kernel, dtype=np.float32)
    if k.ndim != 4:
        raise ValueError(f"expected 4-D conv kernel, got shape {k.shape}")
    tiles = np.transpose(k.mean(axis=2), (2, 0, 1))  # (cout, kh, kw)
    if upscale > 1:
        tiles = np.repeat(np.repeat(tiles, upscale, axis=1), upscale, axis=2)
    return batch_to_grid(tiles, "standardize")
