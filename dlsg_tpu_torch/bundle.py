"""Single-file serving bundles: the port's own copy of `dlsg_tpu.bundle`.

The format is shared with the JAX package, so a bundle written by either
serves both. One compressed ``.npz``, pickle-free:
- ``__dlsg_meta__``: uint8 array of UTF-8 JSON
  ``{"version": 1, "config": {...}, "vocab": [idx2word...]}``
- ``param/<path>/<to>/<leaf>``: one array per generator parameter leaf, in the
  JAX package's layout ('/'-joined flax module path). `weights.py` converts
  that tree to and from this package's `state_dict`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Tuple

import numpy as np

from dlsg_tpu_torch.config import DLSGConfig
from dlsg_tpu_torch.vocab import Vocabulary

BUNDLE_VERSION = 1
_META_KEY = "__dlsg_meta__"
_PARAM_PREFIX = "param/"


def _flatten_params(params, prefix="") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k, v in params.items():
        k = str(k)
        if "/" in k:
            raise ValueError(f"parameter path component contains '/': {k!r}")
        path = f"{prefix}{k}"
        if hasattr(v, "items"):
            flat.update(_flatten_params(v, prefix=f"{path}/"))
        else:
            flat[path] = np.asarray(v)
    return flat


def _unflatten_params(flat: Dict[str, np.ndarray]) -> Dict:
    params: Dict = {}
    for path, arr in flat.items():
        parts = path.split("/")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return params


def save_bundle(path: str, cfg: DLSGConfig, vocab: Vocabulary, params) -> None:
    """Write a version-1 bundle. `params` is the JAX-layout tree of numpy
    arrays (`weights.params_to_jax(model.state_dict())`)."""
    meta = json.dumps({
        "version": BUNDLE_VERSION,
        "config": dataclasses.asdict(cfg),
        "vocab": list(vocab.idx2word),
    })
    arrays = {_PARAM_PREFIX + k: v for k, v in _flatten_params(params).items()}
    arrays[_META_KEY] = np.frombuffer(meta.encode("utf-8"), dtype=np.uint8)
    # through a file object: np.savez_compressed appends '.npz' to str paths
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_bundle(path: str) -> Tuple[DLSGConfig, Vocabulary, Dict]:
    """Read a bundle back into (cfg, vocab, JAX-layout params tree).

    Config fields missing from the bundle keep their defaults; unknown fields
    are dropped."""
    with np.load(path, allow_pickle=False) as data:
        if _META_KEY not in data:
            raise ValueError(f"{path} is not a dlsg bundle (no {_META_KEY})")
        meta = json.loads(bytes(data[_META_KEY].tobytes()).decode("utf-8"))
        if meta.get("version") != BUNDLE_VERSION:
            raise ValueError(
                f"unsupported bundle version {meta.get('version')} "
                f"(this build reads version {BUNDLE_VERSION})"
            )
        flat = {
            k[len(_PARAM_PREFIX):]: data[k]
            for k in data.files
            if k.startswith(_PARAM_PREFIX)
        }
    known = {f.name for f in dataclasses.fields(DLSGConfig)}
    cfg_dict = {
        # JSON turns tuples into lists; every sequence field is a tuple
        k: tuple(v) if isinstance(v, list) else v
        for k, v in meta["config"].items()
        if k in known
    }
    cfg = DLSGConfig(**cfg_dict)
    vocab = Vocabulary.from_idx2word(meta["vocab"])
    return cfg, vocab, _unflatten_params(flat)
