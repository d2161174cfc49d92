"""Published peaks of the cards the benchmark runs on (NVIDIA's H100 SXM data
sheet: dense rates, no sparsity, at the full 700 W power limit)."""

from __future__ import annotations

from typing import Optional

# card name fragment -> peak operations per second by compute dtype, and HBM bytes/s
PEAKS = {
    "H100": {"flops": {"bfloat16": 989e12}, "hbm_bytes_s": 3.35e12},
}


def _entry(device_name: str) -> Optional[dict]:
    return next((v for k, v in PEAKS.items() if k in device_name), None)


def peak_flops(device_name: str, compute_dtype: str) -> Optional[float]:
    """The card's dense peak in the config's compute dtype, or None where
    the table has none (a config in another dtype adds its entry here)."""
    e = _entry(device_name)
    return None if e is None else e["flops"].get(compute_dtype)


def peak_bytes_s(device_name: str) -> Optional[float]:
    e = _entry(device_name)
    return None if e is None else e["hbm_bytes_s"]
