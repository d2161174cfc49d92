"""Flax variables -> the port's state_dict.

The JAX package keeps its weights as `{"params": ..., "batch_stats": ...}`
trees of arrays. This module maps each leaf to the port's parameter or
buffer of the same scope path:

  .../conv/kernel  (HWIO) -> .../conv.weight  (OIHW)
  .../conv/bias           -> .../conv.bias
  .../bn/scale            -> .../bn.weight
  .../bn/bias             -> .../bn.bias
  batch_stats .../bn/mean -> .../bn.running_mean
  batch_stats .../bn/var  -> .../bn.running_var
  .../gn/{scale,bias}     -> .../gn.{weight,bias}     (group norm)
  .../ln/{scale,bias}     -> .../ln.{weight,bias}     (layer norm)
  .../brn/{scale,bias}    -> .../brn.{weight,bias}    (batch renorm)
  batch_stats .../brn/{mean,var,steps} -> .../brn.{running_mean,running_var,steps}
  .../in_scale, .../in_offset -> the same names on the block (instance
                             norm's parameters sit in the ConvBlock's scope)

It raises on a Flax leaf that maps to nothing in the model, on a model
entry that no Flax leaf fills, and on two leaves that fill one entry. Each
leaf keeps the dtype of the entry it fills (the renorm step count is int32).
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_LEAF_NAMES = {
    ("params", "conv", "kernel"): "conv.weight",
    ("params", "conv", "bias"): "conv.bias",
    ("params", "bn", "scale"): "bn.weight",
    ("params", "bn", "bias"): "bn.bias",
    ("batch_stats", "bn", "mean"): "bn.running_mean",
    ("batch_stats", "bn", "var"): "bn.running_var",
    ("params", "gn", "scale"): "gn.weight",
    ("params", "gn", "bias"): "gn.bias",
    ("params", "ln", "scale"): "ln.weight",
    ("params", "ln", "bias"): "ln.bias",
    ("params", "brn", "scale"): "brn.weight",
    ("params", "brn", "bias"): "brn.bias",
    ("batch_stats", "brn", "mean"): "brn.running_mean",
    ("batch_stats", "brn", "var"): "brn.running_var",
    ("batch_stats", "brn", "steps"): "brn.steps",
}
# leaves that sit directly in a ConvBlock's scope (instance norm)
_BLOCK_LEAVES = {("params", "in_scale"), ("params", "in_offset")}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def flax_to_state_dict(variables: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert a Flax variables tree (numpy leaves) into `model`'s state_dict."""
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(collection, {})):
            if (collection, path[-1]) in _BLOCK_LEAVES:
                name = ".".join(path)
            elif len(path) >= 2 and (collection, path[-2], path[-1]) in _LEAF_NAMES:
                name = ".".join(path[:-2] + (_LEAF_NAMES[(collection, path[-2], path[-1])],))
            else:
                raise KeyError(f"unmapped Flax leaf {collection}/{'/'.join(path)}")
            if name not in want:
                raise KeyError(f"Flax leaf {collection}/{'/'.join(path)} -> {name!r}, "
                               "which the model does not have")
            if arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            if name in out:
                raise KeyError(f"two Flax leaves fill {name!r}")
            t = torch.from_numpy(np.array(arr, order="C")).to(want[name].dtype)
            if t.shape != want[name].shape:
                raise ValueError(f"{name}: Flax shape {tuple(t.shape)} vs model "
                                 f"{tuple(want[name].shape)}")
            out[name] = t
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"model entries with no Flax leaf: {missing}")
    return out
