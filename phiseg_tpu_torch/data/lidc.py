"""LIDC-IDRI data pipeline: raw pickle -> patient-level split -> HDF5 cache ->
batch providers (port of phiseg_tpu/data/lidc.py).

Equivalent of the reference `data/lidc_data_loader.py` (prepare_data :46-106,
load_and_maybe_process_data :109-135) and `data/lidc_data.py` (:8-52).

The raw input is Stefan Knegt's LIDC crops pickle: a dict keyed by lesion id
with entries {'image': (128,128) float, 'masks': list of 4 (128,128) binary
masks, 'series_uid': patient id}. Preprocessing:
  * chunked 2GB-safe pickle read (ref :56-61)
  * PATIENT-level 64/16/20 train/val/test split over unique series_uids
    (ref :69-73) so no patient leaks across splits, seeded
  * images stored as float64 - 0.5 (ref :92), masks stacked to (128,128,4)
    uint8 (ref :94-97), a stable blake2 digest of the series_uid per image

The split (`split_lidc`) is numpy only. `prepare_data` writes it in the JAX
package's HDF5 layout (groups train/val/test, datasets images f64, labels u8,
uids i64), so either package reads the other's `data_lidc.hdf5`. h5py is
imported only where that cache is written or read; a machine without it
builds `LIDCData.from_splits` from the split arrays in memory.
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
from typing import Dict

import numpy as np

log = logging.getLogger(__name__)

SPLITS = ("test", "val", "train")


def crop_or_pad_slice_to_size(sl: np.ndarray, nx: int, ny: int) -> np.ndarray:
    """Centre crop-or-zero-pad a 2D slice (ref lidc_data_loader.py:16-35)."""
    x, y = sl.shape
    out = np.zeros((nx, ny), dtype=sl.dtype)
    xs, ys = max((x - nx) // 2, 0), max((y - ny) // 2, 0)
    xc, yc = max((nx - x) // 2, 0), max((ny - y) // 2, 0)
    w, h = min(x, nx), min(y, ny)
    out[xc : xc + w, yc : yc + h] = sl[xs : xs + w, ys : ys + h]
    return out


def _stable_uid(series_uid) -> int:
    """Deterministic 63-bit patient id from a series_uid string."""
    digest = hashlib.blake2b(str(series_uid).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "big") >> 1


def _read_pickle_chunked(path: str):
    """2GB-safe pickle read (ref lidc_data_loader.py:56-61)."""
    max_bytes = 2**31 - 1
    size = os.path.getsize(path)
    buf = bytearray(0)
    with open(path, "rb") as f:
        for _ in range(0, size, max_bytes):
            buf += f.read(max_bytes)
    return pickle.loads(bytes(buf))


def split_lidc(raw: dict, split_seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """The raw pickle's dict -> {split: {"images", "labels", "uids"}} (ref :63-106).

    Patients (unique series_uids) are permuted by a RandomState of
    `split_seed`: the first 20% are test, the next 20% of the rest are
    validation, the others train. Within a split the images keep the raw
    dict's order. The reference used sklearn's train_test_split without a
    seed and stored the salted hash(series_uid) (ref :98); the split here is
    seeded and the uid is a stable blake2 digest (documented deviations of
    the JAX package, kept so both packages give the same arrays).
    """
    series_uids = np.unique([v["series_uid"] for v in raw.values()])
    rng = np.random.RandomState(split_seed)
    perm = rng.permutation(series_uids)
    n = len(perm)
    n_test = int(round(0.2 * n))
    n_val = int(round(0.2 * (n - n_test)))
    split_ids = {
        "test": set(perm[:n_test]),
        "val": set(perm[n_test : n_test + n_val]),
        "train": set(perm[n_test + n_val :]),
    }

    buckets = {tt: {"images": [], "labels": [], "uids": []} for tt in SPLITS}
    for value in raw.values():
        sid = value["series_uid"]
        tt = next(t for t, ids in split_ids.items() if sid in ids)
        buckets[tt]["images"].append(np.asarray(value["image"], dtype=np.float64) - 0.5)
        buckets[tt]["labels"].append(np.asarray(value["masks"]).transpose((1, 2, 0)))
        buckets[tt]["uids"].append(_stable_uid(sid))
    return {
        tt: {"images": np.asarray(b["images"], dtype=np.float64),
             "labels": np.asarray(b["labels"], dtype=np.uint8),
             "uids": np.asarray(b["uids"], dtype=np.int64)}
        for tt, b in buckets.items()
    }


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "the LIDC HDF5 cache (data_lidc.hdf5) needs h5py, which is not installed; "
            "without it, build the dataset in memory: LIDCData.from_splits(cfg, "
            "split_lidc(_read_pickle_chunked(pickle_path)))") from e
    return h5py


def prepare_data(input_file: str, output_file: str, split_seed: int = 0) -> None:
    """Raw pickle -> HDF5 with patient-level splits (ref :46-106), in the
    JAX package's layout: per split `uids` i64, `labels` u8, `images` f64."""
    h5py = _h5py()
    splits = split_lidc(_read_pickle_chunked(input_file), split_seed)
    with h5py.File(output_file, "w") as f:
        for tt, arrays in splits.items():
            grp = f.create_group(tt)
            for key in ("uids", "labels", "images"):
                grp.create_dataset(key, data=arrays[key])
    log.info("wrote %s", output_file)


def load_and_maybe_process_data(input_file: str, preproc_folder: str,
                                force_overwrite: bool = False):
    """Cache-or-rebuild wrapper (ref lidc_data_loader.py:109-135): the open
    h5py File of `preproc_folder/data_lidc.hdf5`, written first if absent."""
    h5py = _h5py()
    os.makedirs(preproc_folder, exist_ok=True)
    path = os.path.join(preproc_folder, "data_lidc.hdf5")
    if not os.path.exists(path) or force_overwrite:
        log.info("preprocessing LIDC pickle -> %s", path)
        prepare_data(input_file, path)
    else:
        log.info("loading cached %s", path)
    return h5py.File(path, "r")


class LIDCData:
    """Train/val/test batch providers over the LIDC splits (ref lidc_data.py:8-52).

    `LIDCData(cfg, pickle_path, preproc_folder)` reads the HDF5 cache (built
    from the pickle if absent); `LIDCData.from_splits(cfg, split_lidc(raw))`
    takes the split arrays in memory. Either way the providers, their seeds
    (seed, seed+1, seed+2) and the raw `.images` / `.labels` of validation and
    test are the same.
    """

    def __init__(self, cfg, data_root: str, preproc_folder: str,
                 host_augment: bool = False, seed: int = 0):
        self._build(cfg, load_and_maybe_process_data(data_root, preproc_folder),
                    host_augment, seed)

    @classmethod
    def from_splits(cls, cfg, splits, host_augment: bool = False, seed: int = 0):
        """The dataset over split arrays in memory ({split: {"images", "labels", ...}})."""
        self = cls.__new__(cls)
        self._build(cfg, splits, host_augment, seed)
        return self

    def _build(self, cfg, data, host_augment: bool, seed: int) -> None:
        from phiseg_tpu_torch.data.batch_provider import BatchProvider

        self.data = data
        kw = dict(
            add_dummy_dimension=True,
            num_labels_per_subject=cfg.num_labels_per_subject,
            annotator_range=cfg.annotator_range,
            resize_to=getattr(cfg, "resize_to", None),
        )
        self.train = BatchProvider(
            data["train"]["images"], data["train"]["labels"],
            np.arange(data["train"]["images"].shape[0]),
            do_augmentations=host_augment,
            augmentation_options=cfg.augmentation_options,
            seed=seed, **kw,
        )
        self.validation = BatchProvider(
            data["val"]["images"], data["val"]["labels"],
            np.arange(data["val"]["images"].shape[0]), seed=seed + 1, **kw,
        )
        self.test = BatchProvider(
            data["test"]["images"], data["test"]["labels"],
            np.arange(data["test"]["images"].shape[0]), seed=seed + 2, **kw,
        )
        # Raw array access for full-volume eval (ref lidc_data.py:48-52).
        self.validation.images = data["val"]["images"]
        self.validation.labels = data["val"]["labels"]
        self.test.images = data["test"]["images"]
        self.test.labels = data["test"]["labels"]
