"""Evaluation: greedy, beam and two-pass decode functions, evaluate() with
scoring, and best-result tracking."""

from dlsg_tpu_torch.evaluation.decode import make_decode_fn  # noqa: F401
from dlsg_tpu_torch.evaluation.evaluate import evaluate  # noqa: F401
from dlsg_tpu_torch.evaluation.results import ResultHandler  # noqa: F401
