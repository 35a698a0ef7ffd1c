"""Serving API (counterpart of `dlsg_tpu/serve.py`).

Load the model once, then caption pre-extracted feature batches:

    captioner = Captioner.from_bundle("model.dlsg.npz")        # on cuda
    captioner = Captioner.from_checkpoint(cfg, vocab)          # best_CIDEr
    sentences = captioner.caption(frames, regions)             # beam search
    sentences = captioner.caption(frames, regions, greedy=True)

Requests of any size are padded to a power-of-two bucket. `from_checkpoint`
reads this package's checkpoints (`checkpoint.py`); a model trained by the
JAX package comes over as a bundle (its `dlsg-tpu export`).

Under a mesh (`mesh=`, parallel/mesh.py; one process per card) every rank
calls `caption` with the same clips. The parameters stay whole on every
rank (JAX's `place_replicated`); each bucket is padded to a multiple of the
data axis, each data index decodes its contiguous block of rows, and the
token ids are all-gathered over the data axis and cut back to the request.
`server.py` feeds the other ranks the leader's requests.
"""

from __future__ import annotations

from dataclasses import replace
from typing import List, Mapping, Optional

import numpy as np
import torch

from dlsg_tpu_torch.bundle import load_bundle
from dlsg_tpu_torch.checkpoint import restore_model
from dlsg_tpu_torch.config import DLSGConfig
from dlsg_tpu_torch.data.prefetch import stage_cast
from dlsg_tpu_torch.device import DeviceLike, resolve_device
from dlsg_tpu_torch.evaluation.decode import make_decode_fn
from dlsg_tpu_torch.models.generator import CapGnnModel
from dlsg_tpu_torch.parallel import dist
from dlsg_tpu_torch.parallel.mesh import Mesh
from dlsg_tpu_torch.vocab import Vocabulary
from dlsg_tpu_torch.weights import params_from_jax


def jsonable_id(vid):
    """Normalize a video id (numpy scalar / str / int) for JSON output:
    integer ids stay integers, anything else becomes a string."""
    v = vid.item() if hasattr(vid, "item") else vid
    return int(v) if isinstance(v, (int, np.integer)) else str(v)


class Captioner:
    """Load-once captioner. `cfg` is taken as final (apply the dataset
    overrides yourself if you built it by hand).

    `params` is this package's `state_dict` (`weights.params_from_jax`
    converts a JAX parameter tree). Runs on `device`, default `cuda`.
    `fast=True` sets the JAX package's approximate-top-k recall; this package
    always takes the exact top-k, so the captions do not change. `mesh`
    (default: none, one process) splits each bucket over its data axis
    (module doc)."""

    # smallest batch shape; buckets double from here up to test_batch_size
    MIN_BUCKET = 8

    def __init__(
        self,
        cfg: DLSGConfig,
        vocab: Vocabulary,
        params: Mapping[str, torch.Tensor],
        fast: bool = False,
        device: DeviceLike = None,
        mesh: Optional[Mesh] = None,
    ):
        self.device = resolve_device(device)
        if fast:
            cfg = replace(cfg, decode_approx_topk=0.95)
        if mesh is not None:
            dist.set_mesh(mesh)
        self.mesh = mesh
        self.cfg = cfg
        self.vocab = vocab
        self.model = CapGnnModel(cfg, len(vocab), device=self.device)
        self.model.load_state_dict(params)
        self._beam_fn = make_decode_fn(self.model, cfg, beam_size=cfg.beam_size, device=self.device)
        self._greedy_fn = make_decode_fn(self.model, cfg, beam_size=1, device=self.device)
        self._batch = cfg.test_batch_size
        self.warm = False  # flipped by warmup()

    @classmethod
    def from_params(
        cls, cfg: DLSGConfig, vocab: Vocabulary, params, fast: bool = False,
        device: DeviceLike = None, mesh: Optional[Mesh] = None,
    ) -> "Captioner":
        return cls(cfg, vocab, params, fast=fast, device=device, mesh=mesh)

    @classmethod
    def from_checkpoint(
        cls,
        cfg: DLSGConfig,
        vocab: Vocabulary,
        ckpt_dir: Optional[str] = None,
        name: str = "best_CIDEr",
        fast: bool = False,
        device: DeviceLike = None,
        mesh: Optional[Mesh] = None,
    ) -> "Captioner":
        """Load the generator a trainer saved as `name` (best_CIDEr,
        best_Bleu_4) under `ckpt_dir` (default cfg.checkpoint_dir); `fast`
        and `mesh` as in the constructor."""
        device = resolve_device(device)
        params = restore_model(ckpt_dir or cfg.checkpoint_dir, name, device=device)
        return cls(cfg, vocab, params, fast=fast, device=device, mesh=mesh)

    @classmethod
    def from_bundle(cls, path: str, fast: bool = False, device: DeviceLike = None,
                    mesh: Optional[Mesh] = None) -> "Captioner":
        """Load a single-file serving bundle (written by either package)."""
        cfg, vocab, tree = load_bundle(path)
        return cls(cfg, vocab, params_from_jax(tree), fast=fast, device=device, mesh=mesh)

    def _bucket_size(self, n: int) -> int:
        """Smallest power-of-two bucket >= n (capped at the full batch size)."""
        b = self.MIN_BUCKET
        while b < min(n, self._batch):
            b *= 2
        return min(b, self._batch)

    def bucket_sizes(self) -> List[int]:
        """The bounded set of batch shapes requests can land on."""
        sizes, b = [], self.MIN_BUCKET
        while b < self._batch:
            sizes.append(b)
            b *= 2
        sizes.append(self._batch)
        return sorted({min(s, self._batch) for s in sizes})

    def warmup(self, greedy: bool = False) -> int:
        """Run every bucket shape once (kernel builds, allocator and library
        warm-up happen here, not in a live request). Returns the number of
        shapes run; with `greedy`, warms the greedy decoder instead."""
        cfg = self.cfg
        for b in self.bucket_sizes():
            fr = np.zeros((b, cfg.max_frames, cfg.feature_size), np.float32)
            rg = np.zeros((b, cfg.max_frames, cfg.num_obj, cfg.region_feature_size), np.float32)
            self.caption(fr, rg, greedy=greedy)
        self.warm = True
        return len(self.bucket_sizes())

    def caption(self, frames, regions, greedy: bool = False) -> List[str]:
        """Caption a batch of feature clips.

        frames: [N, max_frames, 2560]; regions: [N, max_frames, >=num_obj, 2048].
        Any N, padded internally to a power-of-two bucket. Returns N strings.
        Under a mesh every rank passes the same clips and gets all N."""
        cfg = self.cfg
        frames = np.asarray(frames, np.float32)
        regions = np.asarray(regions, np.float32)[:, :, : cfg.num_obj, :]
        fn = self._greedy_fn if greedy else self._beam_fn
        n_data = self.mesh.n_data if self.mesh is not None else 1
        out: List[str] = []
        B = self._batch
        for s in range(0, frames.shape[0], B):
            fr = frames[s : s + B]
            rg = regions[s : s + B]
            n = fr.shape[0]
            b = self._bucket_size(n)
            b += (-b) % n_data  # a block of rows for each data index
            if n < b:  # pad to the bucket's shape with copies of the last row
                fr = np.concatenate([fr, np.repeat(fr[-1:], b - n, 0)], 0)
                rg = np.concatenate([rg, np.repeat(rg[-1:], b - n, 0)], 0)
            if n_data > 1:
                per = b // n_data
                d = self.mesh.data_index
                fr, rg = fr[d * per:(d + 1) * per], rg[d * per:(d + 1) * per]
            sd = cfg.stage_dtype
            ids = fn(stage_cast(fr, sd), stage_cast(rg, sd))
            if n_data > 1:
                (ids,) = dist.all_gather_tensors([ids], self.mesh.data_group)
                ids = ids.reshape(b, -1)
            out.extend(self.vocab.decode_tokens(t) for t in ids.cpu().numpy()[:n])
        return out
