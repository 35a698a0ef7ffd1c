"""Vocabulary: the port's own copy of `dlsg_tpu.vocab`.

Special-token layout `<pad>=0, <start>=1, <end>=2, <unk>=3`, which the
decoder, beam search and detokenization rely on. Loads the reference's
pickled vocabularies (`load_reference_pkl`) and the JSON form of either
package (`save_json` / `load_json`).
"""

from __future__ import annotations

import json
import pickle
from typing import Iterable, List

PAD, START, END, UNK = "<pad>", "<start>", "<end>", "<unk>"
PAD_ID, START_ID, END_ID, UNK_ID = 0, 1, 2, 3


class Vocabulary:
    """word <-> index map with fixed special tokens."""

    def __init__(self) -> None:
        self.word2idx = {}
        self.idx2word: List[str] = []
        self.nwords = 0
        for w in (PAD, START, END, UNK):
            self.add_word(w)

    def add_word(self, w: str) -> None:
        if w not in self.word2idx:
            self.word2idx[w] = self.nwords
            self.idx2word.append(w)
            self.nwords += 1

    def __call__(self, w: str) -> int:
        return self.word2idx.get(w, self.word2idx[UNK])

    def __len__(self) -> int:
        return self.nwords

    @classmethod
    def from_words(cls, words: Iterable[str]) -> "Vocabulary":
        v = cls()
        for w in words:
            v.add_word(w)
        return v

    @classmethod
    def from_idx2word(cls, idx2word) -> "Vocabulary":
        """Rebuild from a saved id->word list (json / bundle serialization)."""
        v = cls.__new__(cls)
        v.idx2word = list(idx2word)
        v.word2idx = {w: i for i, w in enumerate(v.idx2word)}
        v.nwords = len(v.idx2word)
        return v

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.idx2word, f)

    @classmethod
    def load_json(cls, path: str) -> "Vocabulary":
        with open(path) as f:
            return cls.from_idx2word(json.load(f))

    @classmethod
    def load_reference_pkl(cls, path: str) -> "Vocabulary":
        """Import a pickled Vocabulary of the reference codebase (or of the
        JAX package): any pickled class named `Vocabulary`, whatever its
        module path (`utils.utils.Vocabulary` in the reference,
        train_debug.py:25-26), is read as this class."""
        this = cls

        class _Remap(pickle.Unpickler):
            def find_class(self, module, name):
                if name == "Vocabulary":
                    return this
                return super().find_class(module, name)

        with open(path, "rb") as f:
            obj = _Remap(f).load()
        if not isinstance(obj, cls):
            raise TypeError(f"unsupported vocab pickle payload: {type(obj)!r}")
        return obj

    def decode_tokens(self, tokens) -> str:
        """Token ids -> caption string, truncating at the first <end>
        (`<pad>`/`<start>` are kept, as in the reference)."""
        words = []
        for t in tokens:
            t = int(t)
            if t == END_ID:
                break
            words.append(self.idx2word[t])
        return " ".join(words)
