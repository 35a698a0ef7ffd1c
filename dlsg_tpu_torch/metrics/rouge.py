"""ROUGE-L.

Exact semantic port of `caption-eval/pycocoevalcap/rouge/rouge.py`: LCS-based
F-measure with beta=1.2 (`rouge.py:43`), max precision / max recall over
references taken independently (`rouge.py:68-71`).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _lcs_len(a: List[str], b: List[str]) -> int:
    """Length of the longest common subsequence (rouge.py:14-34)."""
    if len(a) < len(b):
        a, b = b, a
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


class Rouge:
    """coco-caption Rouge API."""

    def __init__(self):
        self.beta = 1.2

    def method(self) -> str:
        return "Rouge"

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        assert len(candidate) == 1 and len(refs) > 0
        tok_c = candidate[0].split(" ")
        prec, rec = [], []
        for reference in refs:
            tok_r = reference.split(" ")
            lcs = _lcs_len(tok_r, tok_c)
            prec.append(lcs / float(len(tok_c)))
            rec.append(lcs / float(len(tok_r)))
        pm, rm = max(prec), max(rec)
        if pm != 0 and rm != 0:
            return ((1 + self.beta**2) * pm * rm) / float(rm + self.beta**2 * pm)
        return 0.0

    def compute_score(self, gts, res) -> Tuple[float, np.ndarray]:
        assert sorted(gts.keys()) == sorted(res.keys())
        ids = sorted(gts.keys())
        scores = [self.calc_score(res[id_], gts[id_]) for id_ in ids]
        return float(np.mean(scores)), np.array(scores)
