"""Host-side batch provider (numpy-only copy of phiseg_tpu/data/batch_provider.py).

The original cannot be imported without jax (its package __init__ pulls in
the dataset registry, which imports the JAX config). This copy keeps the
provider's behaviour: epoch-exhaustive random sampling without replacement
(ref batch_provider.py:43-67), sequential iteration (:69-96), per-sample
random annotator selection (:131-137) and the optional resize / host
augmentation / normalise / rescale post-processing, drawing from its
RandomState in the JAX provider's order. The port's main path augments on
the card (phiseg_tpu_torch/data/augment_device.py); `do_augmentations=True`
augments on the host instead (phiseg_tpu_torch/data/augment_host.py).
"""

from __future__ import annotations

import threading
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from phiseg_tpu_torch.utils.misc import normalise_images


def resize_batch(batch: np.ndarray, target_size: Sequence[int]) -> np.ndarray:
    """Nearest-neighbour resize of a batch's spatial dims (H, W).

    Equivalent of the reference's `resize_batch` (batch_provider.py:12-16):
    scipy zoom with order=0 over axes 1-2, channels untouched. Also accepts
    3-D (B, H, W) label batches, which the reference's 4-factor zoom cannot.
    """
    from scipy.ndimage import zoom

    fx = float(target_size[0]) / batch.shape[1]
    fy = float(target_size[1]) / batch.shape[2]
    factors = (1.0, fx, fy) + (1.0,) * (batch.ndim - 3)
    return zoom(batch, factors, order=0)


def canonicalise_aug_options(opts: Mapping[str, Any]) -> dict:
    """Map the reference's inconsistent flip keys onto one spelling."""
    o = dict(opts)
    if "do_flip_lr" in o:
        o.setdefault("do_fliplr", o.pop("do_flip_lr"))
    if "do_flip_ud" in o:
        o.setdefault("do_flipud", o.pop("do_flip_ud"))
    return o


class BatchProvider:
    """Mini-batch access over (images, labels) arrays or HDF5 datasets."""

    def __init__(
        self,
        images,
        labels,
        indices: np.ndarray,
        add_dummy_dimension: bool = True,
        num_labels_per_subject: int = 1,
        annotator_range: Optional[Sequence[int]] = None,
        do_augmentations: bool = False,
        augmentation_options: Optional[Mapping[str, Any]] = None,
        normalise: bool = False,
        rescale_range: Optional[tuple] = None,
        resize_to: Optional[Sequence[int]] = None,
        seed: Optional[int] = None,
    ):
        self.images = images
        self.labels = labels
        self.indices = np.asarray(indices)
        self.unused_indices = self.indices.copy()
        self.add_dummy_dimension = add_dummy_dimension
        self.num_labels_per_subject = num_labels_per_subject
        self.annotator_range = (
            list(annotator_range)
            if annotator_range is not None
            else list(range(num_labels_per_subject))
        )
        self.do_augmentations = do_augmentations
        self.augmentation_options = canonicalise_aug_options(augmentation_options or {})
        self.normalise = normalise
        self.rescale_range = rescale_range
        self.resize_to = tuple(resize_to) if resize_to is not None else None
        self.rng = np.random.RandomState(seed)
        # next_batch may be called from the trainer's prefetch thread AND the
        # validation path concurrently; RandomState and the epoch bookkeeping
        # are not thread-safe.
        self._lock = threading.Lock()

    # -- sampling -----------------------------------------------------------

    def next_batch(self, batch_size: int):
        """Random batch; sampling without replacement across an epoch
        (ref batch_provider.py:43-67). Thread-safe."""
        with self._lock:
            if len(self.unused_indices) < batch_size:
                self.unused_indices = self.indices
            batch_indices = self.rng.choice(self.unused_indices, batch_size,
                                            replace=False)
            self.unused_indices = np.setdiff1d(self.unused_indices, batch_indices)
            # HDF5 fancy indexing requires sorted indices (ref :56).
            batch_indices = np.sort(batch_indices)

            x = np.asarray(self.images[batch_indices, ...])
            y = np.asarray(self.labels[batch_indices, ...])
            if self.num_labels_per_subject > 1:
                y = self._select_random_label(y)
            return self._post_process(x, y)

    def iterate_batches(self, batch_size: int, shuffle: bool = True):
        """Sequential epoch generator (ref batch_provider.py:69-96).

        Thread-safe against a concurrent next_batch (the trainer's prefetch
        thread): the iteration order is a locked snapshot (self.indices is
        never mutated, unlike the reference's in-place shuffle), and each
        batch's HDF5 read + RandomState draw happens under the lock. The
        lock is NOT held across yields.
        """
        with self._lock:
            order = self.indices.copy()
            if shuffle:
                self.rng.shuffle(order)
        n = order.shape[0]
        for b in range(0, n, batch_size):
            batch_indices = np.sort(order[b : b + batch_size])
            with self._lock:
                x = np.asarray(self.images[batch_indices, ...])
                y = np.asarray(self.labels[batch_indices, ...])
                if self.num_labels_per_subject > 1:
                    y = self._select_random_label(y)
                batch = self._post_process(x, y)
            yield batch

    # -- internals -----------------------------------------------------------

    def _select_random_label(self, labels: np.ndarray) -> np.ndarray:
        """One random annotator per sample (ref batch_provider.py:131-137)."""
        picks = self.rng.choice(self.annotator_range, size=labels.shape[0])
        return np.stack([labels[i, ..., a] for i, a in enumerate(picks)], axis=0)

    def _post_process(self, x: np.ndarray, y: np.ndarray):
        if self.resize_to is not None:
            # Before augmentation, like the reference (:101-103); labels are
            # resized too unless scalar-per-sample (ref guards on ndim > 1).
            x = resize_batch(x, self.resize_to)
            if y.ndim > 1:
                y = resize_batch(y, self.resize_to)
        if self.do_augmentations:
            from phiseg_tpu_torch.data.augment_host import augment_batch_host

            x, y = augment_batch_host(x, y, self.augmentation_options, self.rng)
        if self.normalise:
            x = normalise_images(x)
        if self.rescale_range is not None:
            lo, hi = self.rescale_range
            x = x.astype(np.float32)
            mn, mx = x.min(), x.max()
            x = (x - mn) / max(mx - mn, 1e-12) * (hi - lo) + lo
        x = x.astype(np.float32)
        if self.add_dummy_dimension and x.ndim == 3:
            x = x[..., None]
        return x, y.astype(np.int32)
