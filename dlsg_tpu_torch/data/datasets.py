"""Dataset readers.

Parity with `utils/data.py`:
- `CaptionDataset`  <- V2TDataset (data.py:13-66): one sample per *caption*;
  captions/pos_tags/lengths/video_ids come from a pickle, frame features from
  `h5[feats][video_id]`, region/spatial features from `h5[vfeats]/h5[sfeats]`.
- `EvalVideoDataset` <- VideoDataset (data.py:69-86): one sample per *video* over
  an id range.
- MSR-VTT sharded region h5 files are concatenated on first use
  (data.py:24-46).

Deliberate departures (SURVEY.md §7): no argparse at import, no sort-by-video-id
ragged collation — batches are dense fixed-shape arrays with explicit length
vectors.

A copy of `dlsg_tpu/data/datasets.py`. `h5py` is imported where a file is
opened, not with the module, so the package (and its CLI) imports where
h5py is not installed. `spawn_spec()` tells a worker process of
`data/parallel_loader.py` how to rebuild a dataset with its own file
handles (h5py handles do not cross a process boundary).
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Optional, Sequence, Tuple

import numpy as np

from dlsg_tpu_torch.config import DLSGConfig


def _to_numpy_captions(captions, lengths, max_words: int) -> Tuple[np.ndarray, np.ndarray]:
    """Normalize pickled captions (torch tensors or arrays) to int32 [N, T]."""
    arrs = []
    for c in captions:
        a = np.asarray(c, dtype=np.int32).reshape(-1)[:max_words]
        if a.shape[0] < max_words:
            a = np.pad(a, (0, max_words - a.shape[0]))
        arrs.append(a)
    caps = np.stack(arrs, 0)
    lens = np.asarray([int(l) for l in lengths], dtype=np.int32)
    lens = np.minimum(lens, max_words)
    return caps, lens


def maybe_concat_region_shards(region_h5_path: str, cfg: DLSGConfig) -> None:
    """Concatenate sharded MSR-VTT region h5 files into one (data.py:24-46)."""
    if os.path.exists(region_h5_path):
        return
    pattern = region_h5_path.replace(".h5", "*.h5")
    file_names = sorted(glob.glob(pattern))
    if not file_names:
        return
    import h5py

    region_all, spatial_all = [], []
    for name in file_names:
        with h5py.File(name, "r") as h5:
            region_all.append(np.asarray(h5[cfg.region_visual_feats]))
            spatial_all.append(np.asarray(h5[cfg.region_spatial_feats]))
    with h5py.File(region_h5_path, "w") as out:
        out.create_dataset(cfg.region_visual_feats, data=np.concatenate(region_all, 0))
        out.create_dataset(cfg.region_spatial_feats, data=np.concatenate(spatial_all, 0))


class CaptionDataset:
    """Training dataset: one sample per caption (data.py:13-66)."""

    def __init__(self, cfg: DLSGConfig, cap_pkl: Optional[str] = None):
        import h5py

        self.cfg = cfg
        cap_pkl = cap_pkl or cfg.train_caption_pkl_path
        self._cap_pkl = cap_pkl  # spawn_spec: worker processes rebuild from this
        with open(cap_pkl, "rb") as f:
            captions, pos_tags, lengths, video_ids = pickle.load(f)
        self.captions, self.lengths = _to_numpy_captions(captions, lengths, cfg.max_words)
        self.pos_tags, _ = _to_numpy_captions(pos_tags, lengths, cfg.max_words)
        self.video_ids = np.asarray([int(v) for v in video_ids], dtype=np.int32)

        maybe_concat_region_shards(cfg.region_feature_h5_path, cfg)
        self._frame_h5 = h5py.File(cfg.feature_h5_path, "r")
        self._region_h5 = h5py.File(cfg.region_feature_h5_path, "r")
        self.video_feats = self._frame_h5[cfg.feature_h5_feats]
        self.region_feats = self._region_h5[cfg.region_visual_feats]
        self.spatial_feats = self._region_h5[cfg.region_spatial_feats]

    def __len__(self) -> int:
        return len(self.captions)

    def __getitem__(self, index: int):
        vid = int(self.video_ids[index])
        return {
            "frames": np.asarray(self.video_feats[vid], np.float32),
            "regions": np.asarray(
                self.region_feats[vid][:, : self.cfg.num_obj, :], np.float32
            ),
            "spatials": np.asarray(self.spatial_feats[vid], np.float32),
            "captions": self.captions[index],
            "pos_tags": self.pos_tags[index],
            "lengths": self.lengths[index],
            "video_ids": np.int32(vid),
        }

    def spawn_spec(self):
        """(callable, args) a worker process calls to rebuild this dataset."""
        return (type(self), (self.cfg, self._cap_pkl))

    def get_batch(self, idxs) -> dict:
        """Assemble a whole batch with single-copy h5 reads.

        At real MSR-VTT scale a B=128 batch moves ~1 GiB of region features;
        the per-sample `__getitem__` path pays that twice (h5 read buffer ->
        sample array -> np.stack copy). `read_direct` decompresses/copies each
        video row STRAIGHT into its batch slot, and reads are issued in
        video-id order for forward-seek locality (the row order within the
        batch is preserved). train_batches() uses this automatically.
        """
        idxs = np.asarray(idxs, np.int64)
        B = len(idxs)
        shapes = self.feature_slot_shapes(B)
        bufs = {k: np.empty(*s) for k, s in shapes.items()}
        return self.read_batch_into(idxs, **bufs)

    def feature_slot_shapes(self, batch_size: int) -> dict:
        """{field: ((batch shape), dtype)} of the big per-batch feature
        buffers."""
        O = self.cfg.num_obj
        T, F = self.video_feats.shape[1:]
        _, R = self.region_feats.shape[2:]
        OS, S = self.spatial_feats.shape[2:]  # spatials keep ALL stored boxes
        return {
            "frames": ((batch_size, T, F), np.float32),
            "regions": ((batch_size, T, O, R), np.float32),
            "spatials": ((batch_size, T, OS, S), np.float32),
        }

    def read_batch_into(self, idxs, frames, regions, spatials) -> dict:
        """Assemble rows 0..len(idxs)-1 of a batch STRAIGHT into the supplied
        buffers (first dims may exceed len(idxs)); returns the full batch
        dict with the small host-resident fields."""
        idxs = np.asarray(idxs, np.int64)
        O = self.cfg.num_obj
        vids = self.video_ids[idxs]
        for i in np.argsort(vids, kind="stable"):
            vid = int(vids[i])
            self.video_feats.read_direct(frames, np.s_[vid], np.s_[i])
            self.region_feats.read_direct(
                regions, np.s_[vid, :, :O, :], np.s_[i]
            )
            self.spatial_feats.read_direct(spatials, np.s_[vid], np.s_[i])
        return {
            "frames": frames,
            "regions": regions,
            "spatials": spatials,
            "captions": self.captions[idxs],
            "pos_tags": self.pos_tags[idxs],
            "lengths": self.lengths[idxs],
            "video_ids": vids.astype(np.int32),
        }


class EvalVideoDataset:
    """Eval dataset: one sample per video over an id range (data.py:69-86)."""

    def __init__(self, cfg: DLSGConfig, eval_range: Optional[Tuple[int, int]] = None):
        import h5py

        self.cfg = cfg
        self.eval_list = tuple(range(*(eval_range or cfg.test_range)))
        self._frame_h5 = h5py.File(cfg.feature_h5_path, "r")
        self._region_h5 = h5py.File(cfg.region_feature_h5_path, "r")
        self.video_feats = self._frame_h5[cfg.feature_h5_feats]
        self.region_feats = self._region_h5[cfg.region_visual_feats]
        self.spatial_feats = self._region_h5[cfg.region_spatial_feats]

    def __len__(self) -> int:
        return len(self.eval_list)

    def __getitem__(self, index: int):
        vid = self.eval_list[index]
        return {
            "frames": np.asarray(self.video_feats[vid], np.float32),
            "regions": np.asarray(
                self.region_feats[vid][:, : self.cfg.num_obj, :], np.float32
            ),
            "spatials": np.asarray(self.spatial_feats[vid], np.float32),
            "video_ids": np.int32(vid),
        }

    def spawn_spec(self):
        """See CaptionDataset.spawn_spec. The eval list is rebuilt as the
        range from its first id to its last, so it must be that range."""
        ids = self.eval_list
        rng = (ids[0], ids[-1] + 1) if ids else (0, 0)
        if tuple(ids) != tuple(range(*rng)):
            raise ValueError(f"the eval list is not one contiguous id range: {ids}")
        return (type(self), (self.cfg, rng))

    def get_batch(self, idxs) -> dict:
        """Single-copy batch assembly (see CaptionDataset.get_batch)."""
        idxs = np.asarray(idxs, np.int64)
        shapes = self.feature_slot_shapes(len(idxs))
        bufs = {k: np.empty(*s) for k, s in shapes.items()}
        return self.read_batch_into(idxs, **bufs)

    def feature_slot_shapes(self, batch_size: int) -> dict:
        """See CaptionDataset.feature_slot_shapes."""
        O = self.cfg.num_obj
        T, F = self.video_feats.shape[1:]
        _, R = self.region_feats.shape[2:]
        OS, S = self.spatial_feats.shape[2:]  # spatials keep ALL stored boxes
        return {
            "frames": ((batch_size, T, F), np.float32),
            "regions": ((batch_size, T, O, R), np.float32),
            "spatials": ((batch_size, T, OS, S), np.float32),
        }

    def read_batch_into(self, idxs, frames, regions, spatials) -> dict:
        """See CaptionDataset.read_batch_into."""
        idxs = np.asarray(idxs, np.int64)
        O = self.cfg.num_obj
        vids = np.asarray([self.eval_list[i] for i in idxs], np.int64)
        for i in np.argsort(vids, kind="stable"):
            vid = int(vids[i])
            self.video_feats.read_direct(frames, np.s_[vid], np.s_[i])
            self.region_feats.read_direct(
                regions, np.s_[vid, :, :O, :], np.s_[i]
            )
            self.spatial_feats.read_direct(spatials, np.s_[vid], np.s_[i])
        return {
            "frames": frames,
            "regions": regions,
            "spatials": spatials,
            "video_ids": vids.astype(np.int32),
        }
