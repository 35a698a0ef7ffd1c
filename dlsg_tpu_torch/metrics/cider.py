"""CIDEr.

Exact semantic port of `caption-eval/pycocoevalcap/cider/cider_scorer.py`:
TF-IDF n-gram vectors with document frequency over reference *sets*
(`cider_scorer.py:93-104`), clipped cosine similarity with a length-difference
gaussian penalty sigma=6 (`:133-159`), mean over n in 1..4, divided by the
number of references, scaled by 10 (`:170-178`).
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np


def _ngram_counts(sent: str, n: int = 4) -> Dict[tuple, int]:
    words = sent.split()
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i : i + k])] += 1
    return counts


class Cider:
    """coco-caption Cider API (`cider/cider.py`)."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self._n = n
        self._sigma = sigma

    def method(self) -> str:
        return "CIDEr"

    def compute_score(self, gts, res) -> Tuple[float, np.ndarray]:
        assert sorted(gts.keys()) == sorted(res.keys())
        ids = sorted(gts.keys())
        crefs = [[_ngram_counts(r, self._n) for r in gts[id_]] for id_ in ids]
        ctest = [_ngram_counts(res[id_][0], self._n) for id_ in ids]

        # document frequency over reference sets (cider_scorer.py:93-104)
        doc_freq: Dict[tuple, float] = defaultdict(float)
        for refs in crefs:
            for ngram in set(ng for ref in refs for ng in ref):
                doc_freq[ngram] += 1
        ref_len = np.log(float(len(crefs)))

        def counts2vec(cnts):
            vec = [defaultdict(float) for _ in range(self._n)]
            norm = [0.0] * self._n
            length = 0
            for ngram, tf in cnts.items():
                df = np.log(max(1.0, doc_freq[ngram]))
                k = len(ngram) - 1
                vec[k][ngram] = float(tf) * (ref_len - df)
                norm[k] += vec[k][ngram] ** 2
                if k == 1:  # reference counts length from bigrams (:124)
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        def sim(vh, vr, nh, nr, lh, lr):
            delta = float(lh - lr)
            val = np.zeros(self._n)
            for k in range(self._n):
                for ngram in vh[k]:
                    val[k] += min(vh[k][ngram], vr[k][ngram]) * vr[k][ngram]
                if nh[k] != 0 and nr[k] != 0:
                    val[k] /= nh[k] * nr[k]
                val[k] *= math.e ** (-(delta**2) / (2 * self._sigma**2))
            return val

        scores = []
        for test, refs in zip(ctest, crefs):
            vec, norm, length = counts2vec(test)
            score = np.zeros(self._n)
            for ref in refs:
                vr, nr, lr = counts2vec(ref)
                score += sim(vec, vr, norm, nr, length, lr)
            scores.append(float(np.mean(score) / len(refs) * 10.0))
        arr = np.array(scores)
        return float(np.mean(arr)), arr
