"""GloVe word-embedding import (counterpart of `dlsg_tpu/models/glove.py`;
reference `Decoder.get_glove_embedding`, models/layer.py:352-386).

`load_glove_matrix` builds a [vocab, word_size] matrix from a GloVe text
file (a word and its vector per line): a vocabulary word's trailing comma
is dropped before the lookup, a word missing from the file gets N(0, 0.6)
draws from `np.random.default_rng(seed)` in vocabulary order, and the
matrix is cached as an `.npy` file. The numbers are the JAX package's, bit
for bit. The trainers graft it into the decoder's word embedding after the
model is built (`graft_word_embedding`) and can freeze it
(`freeze_word_embed`, the reference's requires_grad=False, model.py:52-53).
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from dlsg_tpu_torch.vocab import Vocabulary

WORD_EMBED_KEY = "decoder.step.word_embed.embedding"


def load_glove_matrix(
    vocab: Vocabulary,
    word_size: int,
    glove_txt_path: str,
    cache_npy_path: Optional[str] = None,
    seed: int = 0,
) -> np.ndarray:
    """float64 [len(vocab), word_size]; read from `cache_npy_path` when it
    exists, else built and written there."""
    if cache_npy_path and os.path.exists(cache_npy_path):
        return np.load(cache_npy_path)

    glove = {}
    with open(glove_txt_path, "rb") as f:
        for raw in f:
            parts = raw.decode(errors="ignore").split()
            if len(parts) != word_size + 1:
                continue
            glove[parts[0]] = np.asarray(parts[1:], dtype=np.float64)

    rng = np.random.default_rng(seed)
    weights = np.zeros((len(vocab), word_size), np.float64)
    for i, word in enumerate(vocab.idx2word):
        if word.endswith(","):  # layer.py:372-373
            word = word[:-1]
        vec = glove.get(word)
        if vec is not None:
            weights[i] = vec
        else:
            weights[i] = rng.normal(scale=0.6, size=(word_size,))  # layer.py:379
    if cache_npy_path:
        os.makedirs(os.path.dirname(cache_npy_path) or ".", exist_ok=True)
        np.save(cache_npy_path, weights)
    return weights


def graft_word_embedding(params: Mapping[str, torch.Tensor], matrix: np.ndarray) -> Dict[str, torch.Tensor]:
    """A copy of a generator's `state_dict` whose decoder word embedding is
    `matrix`, rounded to fp32."""
    emb = params[WORD_EMBED_KEY]
    if tuple(emb.shape) != matrix.shape:
        raise ValueError(f"GloVe matrix {matrix.shape} does not fit the word embedding {tuple(emb.shape)}")
    out = dict(params)
    out[WORD_EMBED_KEY] = torch.from_numpy(np.asarray(matrix, np.float32)).to(emb.device)
    return out
