"""Dataset registry (port of phiseg_tpu/data/registry.py; ref data/data_switch.py:2-12)."""

from __future__ import annotations

from phiseg_tpu_torch.engine.config import ExperimentConfig, data_root, preproc_root


def get_dataset(cfg: ExperimentConfig, host_augment: bool = False, seed: int = 0,
                **kwargs):
    """Name -> dataset object with .train/.validation/.test providers.

    LIDC reads the pickle at PHISEG_DATA_ROOT through the HDF5 cache in
    PHISEG_PREPROC_ROOT (data/lidc.py; the cache needs h5py)."""
    if cfg.data_identifier == "lidc":
        from phiseg_tpu_torch.data.lidc import LIDCData

        return LIDCData(cfg, data_root(), preproc_root(),
                        host_augment=host_augment, seed=seed)
    if cfg.data_identifier == "synthetic":
        from phiseg_tpu_torch.data.synthetic import SyntheticData

        return SyntheticData(cfg, host_augment=host_augment, seed=seed, **kwargs)
    if cfg.data_identifier in ("acdc", "uzh_prostate"):
        # The reference's data_switch names these too (data/data_switch.py:2-12)
        # but only shipped the LIDC loader; same here.
        raise NotImplementedError(
            f"dataset {cfg.data_identifier!r} is registered for parity with the "
            "reference but no loader was shipped there either; use 'lidc' or "
            "'synthetic', or add a loader in phiseg_tpu_torch/data/."
        )
    raise ValueError(
        f"unknown data identifier: {cfg.data_identifier!r} (known: lidc, synthetic)"
    )
