"""Caption metrics: PTB-style tokenizer, BLEU, CIDEr, ROUGE-L, METEOR, scorer.

Copies of the Python implementations in `dlsg_tpu/metrics`, which re-implement
the reference's vendored coco-caption stack (`caption-eval/`) without Java
subprocesses.
"""

from dlsg_tpu_torch.metrics.scorer import COCOScorer, score_captions  # noqa: F401
