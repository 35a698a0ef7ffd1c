"""Weight bridge between the JAX package's flax parameter tree and this
package's `state_dict`.

Module names are the same in both packages, so a flax path maps to a
`state_dict` key by joining with '.' and renaming the leaf:

| flax leaf                     | torch leaf                           |
|-------------------------------|--------------------------------------|
| Dense `kernel` [in, out]      | Linear `weight` [out, in] (transpose)|
| LayerNorm `scale` [D]         | `weight` [D]                         |
| `bias`, `embedding`, `w_hh`, `theta` | unchanged                     |

LSTM layouts are the JAX ones: `ih` holds b_ih + b_hh in one bias and `w_hh`
is [H, 4H] with gates in (i, f, g, o) order; `SplitInputLSTMCell` holds
`ih_dyn` and a bias-free `ih_static`. The tree is taken in the form
`bundle.load_bundle` returns: nested dicts of numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_TO_TORCH = {"kernel": "weight", "scale": "weight"}


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
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: expected a 2-D Dense kernel, got {arr.shape}")
            arr = arr.T
        key = ".".join([*mods, _TO_TORCH.get(name, name)])
        out[key] = torch.tensor(arr)  # a copy: bundle arrays may be read-only
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """torch `state_dict` -> flax parameter tree of fp32 numpy arrays."""
    tree: Dict = {}
    for key, t in state_dict.items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        *mods, name = key.split(".")
        if name == "weight":
            # Linear weights are 2-D, LayerNorm weights 1-D
            name = "kernel" if arr.ndim == 2 else "scale"
            if arr.ndim == 2:
                arr = arr.T
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return tree
