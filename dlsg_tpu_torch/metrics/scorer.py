"""COCO-style caption scorer.

Parity with `caption-eval/cocoeval.py:51-134` (COCOScorer): tokenize GT +
predictions with the PTB tokenizer, run Bleu(4)/Meteor/Rouge/Cider, collect
corpus and per-image scores — all in-process (no Java subprocesses, no
fd-level stdout suppression needed). A copy of `dlsg_tpu/metrics/scorer.py`.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

from dlsg_tpu_torch.metrics.bleu import Bleu
from dlsg_tpu_torch.metrics.cider import Cider
from dlsg_tpu_torch.metrics.meteor import Meteor
from dlsg_tpu_torch.metrics.rouge import Rouge
from dlsg_tpu_torch.metrics.tokenizer import tokenize_captions


class COCOScorer:
    """Drop-in equivalent of `cocoeval.py:COCOScorer`."""

    def __init__(self, verbose: bool = False):
        self.verbose = verbose
        self.eval: Dict[str, float] = {}
        self.imgToEval: Dict[str, Dict[str, float]] = {}

    def score(self, GT, RES, IDs) -> Tuple[Dict[str, float], None]:
        gts = {id_: GT[id_] for id_ in IDs}
        res = {id_: RES[id_] for id_ in IDs}
        gts = tokenize_captions(gts)
        res = tokenize_captions(res)

        scorers = [
            (Bleu(4), ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4"]),
            (Meteor(), "METEOR"),
            (Rouge(), "ROUGE_L"),
            (Cider(), "CIDEr"),
        ]
        self.eval = {}
        self.imgToEval = {}
        for scorer, method in scorers:
            score, scores = scorer.compute_score(gts, res)
            if isinstance(method, list):
                for sc, scs, m in zip(score, scores, method):
                    self._set_eval(sc, m)
                    self._set_img_scores(scs, IDs, m)
            else:
                self._set_eval(score, method)
                self._set_img_scores(scores, IDs, method)
            if self.verbose:
                print(f"{method}: {score}")
        return self.eval, None

    def _set_eval(self, score, method):
        self.eval[method] = float(score)

    def _set_img_scores(self, scores, ids, method):
        for id_, s in zip(ids, scores):
            self.imgToEval.setdefault(id_, {"image_id": id_})[method] = float(s)


def score_captions(
    references: Dict[str, List[dict]], predictions: Dict[str, str]
) -> Dict[str, float]:
    """Score {vid: caption_str} predictions against coco-format references.

    Mirrors the evaluate() flow (`evaluate.py:85-98`): predictions are wrapped
    into coco format (`evaluate.py:50-54`) and scored over their own key set.
    """
    pred_json = {
        str(k): [{"video_id": str(k), "caption": v}] for k, v in predictions.items()
    }
    refs = {str(k): v for k, v in references.items()}
    scorer = COCOScorer()
    scores, _ = scorer.score(refs, pred_json, list(pred_json.keys()))
    return scores


def load_references_txt(path: str) -> Dict[str, List[dict]]:
    """Parse `vid\\tsentence` reference files into coco format, ascii-filtered
    (`evaluate.py:16-38`)."""
    out: Dict[str, List[dict]] = {}
    with open(path) as f:
        for line in f:
            if "\t" not in line:
                continue
            vid, sent = line.split("\t", 1)
            sent = sent.strip().encode("ascii", "ignore").decode("ascii")
            out.setdefault(vid, []).append(
                {"video_id": vid, "cap_id": len(out.get(vid, [])), "caption": sent}
            )
    return out
