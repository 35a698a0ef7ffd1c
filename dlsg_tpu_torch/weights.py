"""Weight bridge between the JAX package's flax parameter tree and this
package's `state_dict`.

Module names are the same in both packages, so a flax path maps to a
`state_dict` key by joining with '.' and renaming the leaf:

| flax leaf                     | torch leaf                           |
|-------------------------------|--------------------------------------|
| Dense `kernel` [in, out]      | Linear `weight` [out, in] (transpose)|
| Conv `kernel` [k, in, out]    | Conv1d `weight` [out, in, k]         |
| LayerNorm `scale` [D]         | `weight` [D]                         |
| `bias`, `embedding`, `w_hh`, `theta`, `fusion` | unchanged           |

LSTM layouts are the JAX ones: `ih` holds b_ih + b_hh in one bias and `w_hh`
is [H, 4H] with gates in (i, f, g, o) order; `SplitInputLSTMCell` holds
`ih_dyn` and a bias-free `ih_static`. The tree is taken in the form
`bundle.load_bundle` returns: nested dicts of numpy arrays.

A flax `BatchNorm` (models/graph_variants.py) keeps its running statistics
in the `batch_stats` collection, the port in buffers of the same module:
`mean` -> `running_mean`, `var` -> `running_var` (`batch_stats_from_jax`,
`batch_stats_to_jax`); its `scale`/`bias` are parameters, mapped as above.
`params_to_jax` leaves the two buffers out.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_TO_TORCH = {"kernel": "weight", "scale": "weight"}
_STATS_TO_TORCH = {"mean": "running_mean", "var": "running_var"}
_STATS_TO_JAX = {v: k for k, v in _STATS_TO_TORCH.items()}


def _walk(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _walk(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax parameter tree (nested dicts of arrays) -> torch `state_dict`."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        *mods, name = path
        if name == "kernel":
            if arr.ndim not in (2, 3):
                raise ValueError(
                    f"{'/'.join(path)}: expected a 2-D Dense or 3-D Conv kernel, got {arr.shape}"
                )
            arr = arr.T  # [in, out] -> [out, in]; [k, in, out] -> [out, in, k]
        key = ".".join([*mods, _TO_TORCH.get(name, name)])
        out[key] = torch.tensor(arr)  # a copy: bundle arrays may be read-only
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """torch `state_dict` -> flax parameter tree of fp32 numpy arrays."""
    tree: Dict = {}
    for key, t in state_dict.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        *mods, name = key.split(".")
        if name in _STATS_TO_JAX:  # batch_stats, not params
            continue
        if name == "weight":
            # Linear weights are 2-D, Conv1d weights 3-D, LayerNorm weights 1-D
            name = "scale" if arr.ndim == 1 else "kernel"
            if arr.ndim > 1:
                arr = arr.T
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


def batch_stats_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax `batch_stats` tree -> the BatchNorms' `running_mean` /
    `running_var` entries of a torch `state_dict`."""
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _walk(tree):
        *mods, name = path
        out[".".join([*mods, _STATS_TO_TORCH[name]])] = torch.tensor(
            np.asarray(leaf, dtype=np.float32))
    return out


def batch_stats_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The `running_mean` / `running_var` entries of a torch `state_dict`
    -> flax `batch_stats` tree of fp32 numpy arrays (other entries are
    left out)."""
    tree: Dict = {}
    for key, t in state_dict.items():
        *mods, name = key.split(".")
        if name not in _STATS_TO_JAX:
            continue
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[_STATS_TO_JAX[name]] = np.ascontiguousarray(t.detach().to("cpu", torch.float32).numpy())
    return tree
