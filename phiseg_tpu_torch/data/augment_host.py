"""Host-side augmentation (numpy/scipy copy of phiseg_tpu/data/augment_host.py).

Mirrors the reference pipeline (data/batch_provider.py:140-271): per-image
rotate / scale-crop / elastic (3x3 coarse displacement field) / flips, with
every-nth gating and the bilinear-on-onehot-then-argmax label treatment
(utils.py:18-67). The reference implements the warps with cv2; this module
uses scipy.ndimage, as the JAX package does: same transform family, same
RNG draw sequence, pixel-level interpolation slightly different from cv2.
It draws from the RandomState in the JAX package's order, so both packages
give bitwise-equal batches. The port's main path augments on the card
(phiseg_tpu_torch/data/augment_device.py); this one runs in the batch
provider with `do_augmentations=True`.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
from scipy import ndimage


def _rotate(img: np.ndarray, angle: float, order: int) -> np.ndarray:
    """Rotate about the image centre, output shape preserved, zero border
    (cv2.warpAffine equivalent of the reference's utils.rotate_image)."""
    return ndimage.rotate(img, angle, reshape=False, order=order, mode="constant")


def _resize(img: np.ndarray, size, order: int) -> np.ndarray:
    """Resize spatial dims to `size` exactly (cv2.resize equivalent)."""
    factors = [float(size[0]) / img.shape[0], float(size[1]) / img.shape[1]]
    factors += [1.0] * (img.ndim - 2)
    out = ndimage.zoom(img, factors, order=order, mode="nearest", grid_mode=True)
    out = out[: size[0], : size[1], ...]
    if out.shape[0] < size[0] or out.shape[1] < size[1]:
        pad = [(0, size[0] - out.shape[0]), (0, size[1] - out.shape[1])]
        pad += [(0, 0)] * (img.ndim - 2)
        out = np.pad(out, pad, mode="edge")
    return out


def _warp(img: np.ndarray, map_y: np.ndarray, map_x: np.ndarray) -> np.ndarray:
    """Dense displacement warp, bilinear, reflected border (cv2.remap with
    BORDER_REFLECT equivalent of the reference's utils.dense_image_warp)."""
    coords = [map_y, map_x]
    if img.ndim == 2:
        return ndimage.map_coordinates(img, coords, order=1, mode="reflect")
    return np.stack(
        [
            ndimage.map_coordinates(img[..., c], coords, order=1, mode="reflect")
            for c in range(img.shape[-1])
        ],
        axis=-1,
    )


def _to_onehot(lbl: np.ndarray, nlabels: int) -> np.ndarray:
    return np.stack([(lbl == i).astype(np.float32) for i in range(nlabels)], -1)


def augment_batch_host(
    images: np.ndarray, labels: np.ndarray, opts: Mapping[str, Any],
    rng: np.random.RandomState,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-image rotate / scale-crop / elastic / flips with every-nth gating."""
    do_rot = opts.get("do_rotations", False)
    do_scale = opts.get("do_scaleaug", False)
    do_elastic = opts.get("do_elasticaug", False)
    do_fliplr = opts.get("do_fliplr", False)
    do_flipud = opts.get("do_flipud", False)
    every_nth = int(opts.get("augment_every_nth", 2))
    nlabels = int(opts.get("nlabels", int(labels.max()) + 1))

    out_x, out_y = [], []
    for ii in range(images.shape[0]):
        img = np.squeeze(images[ii]).astype(np.float32)
        lbl = np.squeeze(labels[ii])

        if rng.randint(every_nth) == 0:
            if do_rot:
                deg = float(opts.get("rot_degrees", 10.0))
                angle = rng.uniform(-deg, deg)
                img = _rotate(img, angle, order=1)
                lbl = np.argmax(_rotate(_to_onehot(lbl, nlabels), angle, order=1),
                                axis=-1)
            if do_scale:
                offset = int(opts.get("offset", 30))
                n_x, n_y = img.shape
                r_y = rng.randint(n_y - offset, n_y + 1)
                p_x = rng.randint(0, n_x - r_y + 1)
                p_y = rng.randint(0, n_y - r_y + 1)
                img = _resize(img[p_y:p_y + r_y, p_x:p_x + r_y], (n_x, n_y), order=1)
                lbl = np.argmax(
                    _resize(_to_onehot(lbl[p_y:p_y + r_y, p_x:p_x + r_y], nlabels),
                            (n_x, n_y), order=1), axis=-1)
            if do_elastic:
                n_x, n_y = img.shape
                dx = _resize(rng.normal(0, 10, (3, 3)).astype(np.float32),
                             (n_x, n_y), order=3)
                dy = _resize(rng.normal(0, 10, (3, 3)).astype(np.float32),
                             (n_x, n_y), order=3)
                gy, gx = np.meshgrid(np.arange(n_x), np.arange(n_y), indexing="ij")
                map_x = (gx + dx).astype(np.float32)
                map_y = (gy + dy).astype(np.float32)
                img = _warp(img, map_y, map_x)
                lbl = np.argmax(_warp(_to_onehot(lbl, nlabels), map_y, map_x),
                                axis=-1)

        if do_fliplr and rng.randint(max(2, every_nth)) == 0:
            img, lbl = np.fliplr(img), np.fliplr(lbl)
        if do_flipud and rng.randint(max(2, every_nth)) == 0:
            img, lbl = np.flipud(img), np.flipud(lbl)

        out_x.append(img)
        out_y.append(lbl)

    return np.asarray(out_x), np.asarray(out_y)
