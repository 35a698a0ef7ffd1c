"""Corpus BLEU-1..4.

Exact semantic port of the vendored coco-caption scorer
(`caption-eval/pycocoevalcap/bleu/bleu_scorer.py`): n-gram clipping against
per-ref max counts, 'closest' effective reference length
(`bleu_scorer.py:69-70`), the tiny/small smoothing constants
(`bleu_scorer.py:200-201`), and the corpus-level brevity penalty applied when
ratio < 1 (`bleu_scorer.py:248-256`). `compute_score` mirrors
`bleu/bleu.py:22-44` (option='closest').
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple


def _ngram_counts(words: List[str], n: int = 4) -> Dict[tuple, int]:
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i : i + k])] += 1
    return counts


def _cook_refs(refs: List[str], n: int = 4):
    reflens, maxcounts = [], {}
    for ref in refs:
        words = ref.split()
        reflens.append(len(words))
        for ngram, cnt in _ngram_counts(words, n).items():
            maxcounts[ngram] = max(maxcounts.get(ngram, 0), cnt)
    return reflens, maxcounts


def _cook_test(test: str, reflens, maxcounts, n: int = 4):
    words = test.split()
    testlen = len(words)
    # 'closest' reflen: min by (|l - testlen|, l) — bleu_scorer.py:69-70
    reflen = min((abs(l - testlen), l) for l in reflens)[1]
    guess = [max(0, testlen - k + 1) for k in range(1, n + 1)]
    correct = [0] * n
    for ngram, cnt in _ngram_counts(words, n).items():
        correct[len(ngram) - 1] += min(maxcounts.get(ngram, 0), cnt)
    return {"testlen": testlen, "reflen": reflen, "guess": guess, "correct": correct}


class Bleu:
    """coco-caption Bleu API (`bleu/bleu.py:14-47`)."""

    def __init__(self, n: int = 4):
        self._n = n

    def method(self) -> str:
        return "Bleu"

    def compute_score(self, gts, res) -> Tuple[List[float], List[List[float]]]:
        assert sorted(gts.keys()) == sorted(res.keys())
        ids = sorted(gts.keys())
        n = self._n
        small, tiny = 1e-9, 1e-15  # bleu_scorer.py:200-201

        total = {"testlen": 0, "reflen": 0, "guess": [0] * n, "correct": [0] * n}
        bleu_list: List[List[float]] = [[] for _ in range(n)]
        for id_ in ids:
            hypo, refs = res[id_], gts[id_]
            assert isinstance(hypo, list) and len(hypo) == 1
            assert isinstance(refs, list) and len(refs) >= 1
            reflens, maxcounts = _cook_refs(refs, n)
            comps = _cook_test(hypo[0], reflens, maxcounts, n)
            total["testlen"] += comps["testlen"]
            total["reflen"] += comps["reflen"]
            for k in range(n):
                total["guess"][k] += comps["guess"][k]
                total["correct"][k] += comps["correct"][k]
            # per-image scores with per-image brevity penalty
            bleu = 1.0
            for k in range(n):
                bleu *= (comps["correct"][k] + tiny) / (comps["guess"][k] + small)
                bleu_list[k].append(bleu ** (1.0 / (k + 1)))
            ratio = (comps["testlen"] + tiny) / (comps["reflen"] + small)
            if ratio < 1:
                for k in range(n):
                    bleu_list[k][-1] *= math.exp(1 - 1 / ratio)

        bleus: List[float] = []
        bleu = 1.0
        for k in range(n):
            bleu *= (total["correct"][k] + tiny) / (total["guess"][k] + small)
            bleus.append(bleu ** (1.0 / (k + 1)))
        ratio = (total["testlen"] + tiny) / (total["reflen"] + small)
        if ratio < 1:
            for k in range(n):
                bleus[k] *= math.exp(1 - 1 / ratio)
        return bleus, bleu_list
