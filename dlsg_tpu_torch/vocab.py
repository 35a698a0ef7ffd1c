"""Vocabulary: the port's own copy of `dlsg_tpu.vocab`.

Special-token layout `<pad>=0, <start>=1, <end>=2, <unk>=3`, which the
decoder, beam search and detokenization rely on.
"""

from __future__ import annotations

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
