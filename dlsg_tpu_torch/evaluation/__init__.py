"""Evaluation: greedy and beam decode functions."""

from dlsg_tpu_torch.evaluation.decode import make_decode_fn  # noqa: F401
