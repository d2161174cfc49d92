"""Miscellaneous host-side utilities (numpy copy of phiseg_tpu/utils/misc.py,
function for function; the port imports nothing of the JAX package).

Equivalent of the reference repo-root `utils.py` (minus the metrics, which
live on the device in phiseg_tpu_torch/metrics): one-hot converters
(:86-101), image normalisation / intensity mapping (:196-252), NIfTI I/O
(:149-170), lr-schedule floor lookup (:70-84), uint8 conversion (:185-194),
CLAHE histogram equalisation (:373-390), Bunch (:174-181), numpy
ncc/norm_l2 (:103-129), all_argmax (:133-135), jaccard (:254-267),
list_mean (:396-399). nibabel and cv2 are imported inside the functions
that need them.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def convert_to_onehot(lblmap: np.ndarray, nlabels: int) -> np.ndarray:
    out = np.zeros(lblmap.shape + (nlabels,), np.uint8)
    for i in range(nlabels):
        out[..., i] = lblmap == i
    return out


def convert_batch_to_onehot(lblbatch: np.ndarray, nlabels: int) -> np.ndarray:
    return convert_to_onehot(lblbatch, nlabels)


def ncc(a: np.ndarray, v: np.ndarray, zero_norm: bool = True) -> float:
    a, v = a.flatten(), v.flatten()
    if zero_norm:
        a = (a - a.mean()) / (a.std() * len(a))
        v = (v - v.mean()) / v.std()
    else:
        a = a / (a.std() * len(a))
        v = v / v.std()
    return float(np.correlate(a, v)[0])


def norm_l2(a: np.ndarray, v: np.ndarray) -> float:
    a, v = a.flatten(), v.flatten()
    a = (a - a.mean()) / (a.std() * len(a))
    v = (v - v.mean()) / v.std()
    return float(np.mean(np.sqrt(a**2 + v**2)))


def jaccard_onehot(pred: np.ndarray, gt: np.ndarray) -> float:
    inter = float(np.sum(pred * gt))
    return inter / (float(np.sum(pred)) + float(np.sum(gt)) - inter)


def all_argmax(arr: np.ndarray, axis=None) -> np.ndarray:
    return np.argwhere(arr == np.amax(arr, axis=axis))


def find_floor_in_list(lst: Sequence[float], t: float):
    """Largest element <= t and its index (ref utils.py:70-84)."""
    best, best_i = -np.inf, None
    for i, n in enumerate(lst):
        if t >= n > best:
            best, best_i = n, i
    if best_i is None:
        raise ValueError(f"all elements larger than t={t}")
    return best, best_i


def list_mean(lst):
    return sum(lst) / len(lst)


def makefolder(folder: str) -> bool:
    if not os.path.exists(folder):
        os.makedirs(folder)
        return True
    return False


class Bunch:
    """Attribute-access struct (ref utils.py:174-181)."""

    def __init__(self, **kwds):
        self.__dict__.update(kwds)


# -- image intensity utilities --------------------------------------------------


def convert_to_uint8(image: np.ndarray) -> np.ndarray:
    image = image - image.min()
    image = 255.0 * np.divide(image.astype(np.float32), max(image.max(), 1e-12))
    return image.astype(np.uint8)


def convert_to_uint8_rgb_fixed(image: np.ndarray) -> np.ndarray:
    image = (image + 1) * 127.5
    return np.clip(image, 0, 255).astype(np.uint8)


def normalise_image(image: np.ndarray) -> np.ndarray:
    img = np.float32(image.copy())
    return (img - img.mean()) / max(img.std(), 1e-12)


def normalise_images(x: np.ndarray) -> np.ndarray:
    out = np.zeros(x.shape, np.float32)
    for i in range(x.shape[0]):
        out[i] = normalise_image(x[i])
    return out


def map_image_to_intensity_range(image: np.ndarray, min_o: float, max_o: float,
                                 percentiles: float = 0) -> np.ndarray:
    min_i = np.percentile(image, 0 + percentiles)
    max_i = np.percentile(image, 100 - percentiles)
    image = (np.divide(image - min_i, max(max_i - min_i, 1e-12)) * (max_o - min_o) + min_o)
    return np.clip(image, min_o, max_o)


def map_images_to_intensity_range(x: np.ndarray, min_o: float, max_o: float,
                                  percentiles: float = 0) -> np.ndarray:
    out = np.zeros(x.shape, np.float32)
    for i in range(x.shape[0]):
        out[i] = map_image_to_intensity_range(x[i], min_o, max_o, percentiles)
    return out


def softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def histogram_equalization(img: np.ndarray) -> np.ndarray:
    """CLAHE on the L channel (ref utils.py:373-390). Requires cv2."""
    import cv2

    lab = cv2.cvtColor(img, cv2.COLOR_BGR2LAB)
    l, a, b = cv2.split(lab)
    clahe = cv2.createCLAHE(clipLimit=3.0, tileGridSize=(8, 8))
    return cv2.cvtColor(cv2.merge((clahe.apply(l), a, b)), cv2.COLOR_LAB2BGR)


# -- NIfTI I/O -------------------------------------------------------------------


def load_nii(img_path: str):
    import nibabel as nib

    nimg = nib.load(img_path)
    return np.asanyarray(nimg.dataobj), nimg.affine, nimg.header


def save_nii(img_path: str, data: np.ndarray, affine, header) -> None:
    import nibabel as nib

    nib.Nifti1Image(data, affine=affine, header=header).to_filename(img_path)


def create_and_save_nii(data: np.ndarray, img_path: str) -> None:
    import nibabel as nib

    nib.save(nib.Nifti1Image(data, np.eye(4)), img_path)
