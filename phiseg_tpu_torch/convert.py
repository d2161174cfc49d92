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
  .../proj/{kernel,bias}  -> .../proj.{weight,bias}   (ResidualUnit's 1x1 shortcut)
  .../Dense_0/kernel (in, out) -> .../Dense_0.weight (out, in)   (Dense)
  .../Dense_0/bias        -> .../Dense_0.bias
  .../conv_d/kernel (HWIO) -> .../conv_d.weight (OIHW)  (DilatedConvBlock)
  .../conv3d/kernel (DHWIO) -> .../conv3d.weight (OIDHW) (Conv3DBlock)
  .../conv_t/kernel (HWIO) -> .../conv_t.weight (IOHW), flipped in space
                             (TransposedConvBlock: flax correlates the
                             dilated input with the kernel as stored, torch's
                             ConvTranspose2d with the flipped kernel)
  .../conv_t3d/kernel (DHWIO) -> .../conv_t3d.weight (IODHW), flipped in space
                             (TransposedConv3DBlock)
  .../{conv_d,conv3d,conv_t,conv_t3d}/bias -> .../<scope>.bias

It raises on a Flax leaf that maps to nothing in the model, on a model
entry that no Flax leaf fills, and on two leaves that fill one entry. Each
leaf keeps the dtype of the entry it fills (the renorm step count is int32).

`flax_train_state_to_port` fills the port's TrainState from a whole
phiseg_tpu TrainState tree (`step`, `params`, `batch_stats`, `opt_state`;
phiseg_tpu/engine/train.py:70-99), as engine/msgpack_reader.py decodes it
from a checkpoint: the weights as above, and optax's state:

  adam      opt_state["0"] = {count, mu, nu}  -> torch Adam's step, exp_avg,
            exp_avg_sq of each parameter (mu and nu transposed as the params)
  momentum  opt_state["0"] = {trace}          -> torch SGD's momentum_buffer
            (with dampening 0 the same recurrence, Nesterov in both)
  sgd       opt_state["0"] = {}               -> no state
  opt_state["1"] = {count}: the learning-rate schedule's step, which the
            port reads from TrainState.step; it must equal `step`.
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
    ("params", "proj", "kernel"): "proj.weight",
    ("params", "proj", "bias"): "proj.bias",
    ("params", "Dense_0", "kernel"): "Dense_0.weight",
    ("params", "Dense_0", "bias"): "Dense_0.bias",
    **{("params", scope, leaf): f"{scope}.{name}"
       for scope in ("conv_d", "conv3d", "conv_t", "conv_t3d")
       for leaf, name in (("kernel", "weight"), ("bias", "bias"))},
}
# scopes of transposed convolutions: their kernels are flipped in space and
# keep (in, out) in torch's layout
_TRANSPOSED = {"conv_t", "conv_t3d"}
# leaves that sit directly in a ConvBlock's scope (instance norm)
_BLOCK_LEAVES = {("params", "in_scale"), ("params", "in_offset")}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v)


def _torch_layout(arr: np.ndarray, scope: str) -> np.ndarray:
    """A Flax kernel in torch's layout: (*K, in, out) -> (out, in, *K) for a
    convolution, (in, out, *K) with K reversed for a transposed one;
    Dense's (in, out) -> (out, in); anything else as it is."""
    n = arr.ndim
    if n >= 3 and scope in _TRANSPOSED:
        return arr[(slice(None, None, -1),) * (n - 2)].transpose(n - 2, n - 1, *range(n - 2))
    if n >= 3:
        return arr.transpose(n - 1, n - 2, *range(n - 2))
    return arr.T if n == 2 else arr


def _convert_collection(tree: Mapping, collection: str,
                        want: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The entries of `want` that the Flax leaves of `tree` (one collection)
    fill, converted to their layout and dtype."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(tree):
        if (collection, path[-1]) in _BLOCK_LEAVES:
            name = ".".join(path)
        elif len(path) >= 2 and (collection, path[-2], path[-1]) in _LEAF_NAMES:
            name = ".".join(path[:-2] + (_LEAF_NAMES[(collection, path[-2], path[-1])],))
        else:
            raise KeyError(f"unmapped Flax leaf {collection}/{'/'.join(path)}")
        if name not in want:
            raise KeyError(f"Flax leaf {collection}/{'/'.join(path)} -> {name!r}, "
                           "which the model does not have")
        arr = _torch_layout(arr, path[-2] if len(path) >= 2 else "")
        if name in out:
            raise KeyError(f"two Flax leaves fill {name!r}")
        t = torch.from_numpy(np.array(arr, order="C")).to(want[name].dtype)
        if t.shape != want[name].shape:
            raise ValueError(f"{name}: Flax shape {tuple(t.shape)} vs model "
                             f"{tuple(want[name].shape)}")
        out[name] = t
    return out


def _require_all(got: Mapping, want, what: str) -> None:
    missing = sorted(set(want) - set(got))
    if missing:
        raise KeyError(f"{what} with no Flax leaf: {missing}")


def flax_to_state_dict(variables: Mapping, model: nn.Module) -> Dict[str, torch.Tensor]:
    """Convert a Flax variables tree (numpy leaves) into `model`'s state_dict."""
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for name, t in _convert_collection(variables.get(collection, {}), collection,
                                           want).items():
            if name in out:
                raise KeyError(f"two Flax leaves fill {name!r}")
            out[name] = t
    _require_all(out, want, "model entries")
    return out


def _expect_keys(tree: Mapping, keys, where: str) -> None:
    if set(tree) != set(keys):
        raise KeyError(f"optimiser state {where} holds {sorted(tree)}, not {sorted(keys)}")


def flax_train_state_to_port(tree: Mapping, state) -> None:
    """Fill the port's TrainState (model, optimiser, step) in place from a
    phiseg_tpu TrainState tree with numpy leaves; see the module docstring.
    Raises on a leaf or an optimiser entry it cannot place."""
    _expect_keys(tree, ("step", "params", "batch_stats", "opt_state"), "TrainState")
    model, opt = state.model, state.optimizer
    model.load_state_dict(flax_to_state_dict(
        {"params": tree["params"], "batch_stats": tree["batch_stats"]}, model))
    step = int(np.asarray(tree["step"]))

    opt_tree = tree["opt_state"]
    _expect_keys(opt_tree, ("0", "1"), "")
    _expect_keys(opt_tree["1"], ("count",), "['1']")
    if int(np.asarray(opt_tree["1"]["count"])) != step:
        raise ValueError(f"the schedule's count {opt_tree['1']['count']} is not the step {step}")
    params = dict(model.named_parameters())
    names = list(params)

    def moments(key):
        got = _convert_collection(opt_tree["0"][key], "params", params)
        _require_all(got, names, f"parameters of {key}")
        return got

    sd = opt.state_dict()
    index = dict(zip(names, sd["param_groups"][0]["params"]))
    if isinstance(opt, torch.optim.Adam):
        _expect_keys(opt_tree["0"], ("count", "mu", "nu"), "['0'] (adam)")
        count = float(np.asarray(opt_tree["0"]["count"]))
        mu, nu = moments("mu"), moments("nu")
        sd["state"] = {index[n]: {"step": torch.tensor(count), "exp_avg": mu[n],
                                  "exp_avg_sq": nu[n]} for n in names}
    elif isinstance(opt, torch.optim.SGD) and opt.defaults["momentum"]:
        _expect_keys(opt_tree["0"], ("trace",), "['0'] (momentum)")
        trace = moments("trace")
        sd["state"] = {index[n]: {"momentum_buffer": trace[n]} for n in names}
    elif isinstance(opt, torch.optim.SGD):
        _expect_keys(opt_tree["0"], (), "['0'] (sgd)")
        sd["state"] = {}
    else:
        raise TypeError(f"no optax state maps to {type(opt).__name__}")
    opt.load_state_dict(sd)
    state.step = step
