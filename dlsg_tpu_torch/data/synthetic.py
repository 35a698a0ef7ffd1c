"""Synthetic data for tests and benchmarks.

The reference ships no data (features live in gitignored HDF5 files); this
module fabricates datasets with the exact shapes of `utils/data.py` samples —
frames [T, 2560], regions [T, num_obj, 2048], captions [26] — so the full
pipeline (train loop, eval loop, metrics) can run hermetically.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from dlsg_tpu_torch.config import DLSGConfig
from dlsg_tpu_torch.vocab import END_ID, Vocabulary

_WORDS = (
    "a the man woman dog cat is are playing running jumping singing cooking "
    "riding guitar piano ball street park video person group people doing "
    "something talking walking eating food small large red blue fast slow"
).split()


def make_vocab(extra_words: int = 0) -> Vocabulary:
    words = list(_WORDS) + [f"w{i}" for i in range(extra_words)]
    return Vocabulary.from_words(words)


class SyntheticDataset:
    """In-memory dataset with CaptionDataset/EvalVideoDataset sample structure."""

    def __init__(
        self,
        cfg: DLSGConfig,
        vocab: Vocabulary,
        num_videos: int = 16,
        captions_per_video: int = 3,
        seed: int = 0,
    ):
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        T, F = cfg.max_frames, cfg.feature_size
        O, R = cfg.num_obj, cfg.region_feature_size
        self.frames = rng.normal(size=(num_videos, T, F)).astype(np.float32)
        self.regions = rng.normal(size=(num_videos, T, O, R)).astype(np.float32)
        self.spatials = rng.normal(
            size=(num_videos, T, O, cfg.spatial_feature_size)
        ).astype(np.float32)

        self.samples: List[Tuple[int, np.ndarray, int]] = []
        self.references: Dict[str, List[str]] = {}
        word_ids = [vocab(w) for w in _WORDS]
        for v in range(num_videos):
            self.references[str(v)] = []
            for _ in range(captions_per_video):
                length = int(rng.integers(3, min(cfg.max_words - 1, 10)))
                toks = rng.choice(word_ids, size=length).astype(np.int32)
                cap = np.zeros(cfg.max_words, np.int32)
                cap[:length] = toks
                cap[length] = END_ID
                self.samples.append((v, cap, length + 1))
                self.references[str(v)].append(
                    " ".join(vocab.idx2word[t] for t in toks)
                )

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        vid, cap, length = self.samples[index]
        return {
            "frames": self.frames[vid],
            "regions": self.regions[vid],
            "spatials": self.spatials[vid],
            "captions": cap,
            "pos_tags": cap,
            "lengths": np.int32(length),
            "video_ids": np.int32(vid),
        }

    def eval_view(self) -> "SyntheticEvalView":
        return SyntheticEvalView(self)


class SyntheticEvalView:
    """Per-video view (EvalVideoDataset equivalent)."""

    def __init__(self, ds: SyntheticDataset):
        self.ds = ds

    def __len__(self) -> int:
        return self.ds.frames.shape[0]

    def __getitem__(self, index: int):
        return {
            "frames": self.ds.frames[index],
            "regions": self.ds.regions[index],
            "spatials": self.ds.spatials[index],
            "video_ids": np.int32(index),
        }


class StructuredSyntheticDataset(SyntheticDataset):
    """Synthetic data where the caption is a FUNCTION of the features.

    Each video belongs to one of `num_classes` latent classes. Videos are a
    class prototype plus i.i.d. feature noise, and every video of a class
    shares the class's fixed caption. Because captions are predictable from
    features, a model that merely memorizes training videos fails on fresh
    noise draws, while one that learned the feature->caption mapping succeeds
    — this is the held-out generalization probe the plain SyntheticDataset
    (random features, arbitrary captions) cannot provide.

    `heldout_view()` returns an eval view over `heldout_per_class` UNSEEN
    videos per class (new noise on the same prototypes); `references` /
    `heldout_references` map video ids to the class captions.
    """

    def __init__(
        self,
        cfg: DLSGConfig,
        vocab: Vocabulary,
        num_classes: int = 4,
        train_per_class: int = 4,
        heldout_per_class: int = 2,
        noise: float = 0.3,
        caption_len: int = 5,
        seed: int = 0,
    ):
        self.cfg = cfg
        rng = np.random.default_rng(seed)
        T, F = cfg.max_frames, cfg.feature_size
        O, R = cfg.num_obj, cfg.region_feature_size

        proto_f = rng.normal(size=(num_classes, T, F)).astype(np.float32)
        proto_r = rng.normal(size=(num_classes, T, O, R)).astype(np.float32)

        def draw(klass):
            f = proto_f[klass] + noise * rng.normal(size=(T, F)).astype(np.float32)
            r = proto_r[klass] + noise * rng.normal(size=(T, O, R)).astype(np.float32)
            return f.astype(np.float32), r.astype(np.float32)

        # one fixed caption per class, distinct word sequences
        word_ids = [vocab(w) for w in _WORDS]
        class_tokens = []
        for c in range(num_classes):
            toks = rng.choice(word_ids, size=caption_len, replace=False).astype(np.int32)
            class_tokens.append(toks)

        n_train = num_classes * train_per_class
        n_held = num_classes * heldout_per_class
        self.frames = np.zeros((n_train + n_held, T, F), np.float32)
        self.regions = np.zeros((n_train + n_held, T, O, R), np.float32)
        self.spatials = rng.normal(
            size=(n_train + n_held, T, O, cfg.spatial_feature_size)
        ).astype(np.float32)
        self.classes = np.zeros(n_train + n_held, np.int32)

        self.samples = []
        self.references = {}
        self.heldout_references = {}
        self._n_train = n_train
        idx = 0
        for c in range(num_classes):
            toks = class_tokens[c]
            sent = " ".join(vocab.idx2word[t] for t in toks)
            cap = np.zeros(cfg.max_words, np.int32)
            cap[: len(toks)] = toks
            cap[len(toks)] = END_ID
            for _ in range(train_per_class):
                self.frames[idx], self.regions[idx] = draw(c)
                self.classes[idx] = c
                self.samples.append((idx, cap.copy(), len(toks) + 1))
                self.references[str(idx)] = [sent]
                idx += 1
        for c in range(num_classes):
            toks = class_tokens[c]
            sent = " ".join(vocab.idx2word[t] for t in toks)
            for _ in range(heldout_per_class):
                self.frames[idx], self.regions[idx] = draw(c)
                self.classes[idx] = c
                self.heldout_references[str(idx)] = [sent]
                idx += 1

    def eval_view(self) -> "_RangeEvalView":
        # only the TRAIN videos (the base class's view would also sweep the
        # held-out rows, which have no entries in `references`)
        return _RangeEvalView(self, 0, self._n_train)

    def heldout_view(self) -> "_RangeEvalView":
        return _RangeEvalView(self, self._n_train, self.frames.shape[0])


class _RangeEvalView:
    """Eval view over an index range [start, stop) of a synthetic dataset."""

    def __init__(self, ds, start: int, stop: int):
        self.ds = ds
        self.start = start
        self.stop = stop

    def __len__(self) -> int:
        return self.stop - self.start

    def __getitem__(self, index: int):
        i = self.start + index
        return {
            "frames": self.ds.frames[i],
            "regions": self.ds.regions[i],
            "spatials": self.ds.spatials[i],
            "video_ids": np.int32(i),
        }
