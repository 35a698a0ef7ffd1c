"""Host utilities: scalar logging, profiling, attention plots."""

from dlsg_tpu_torch.utils.logging import MetricsWriter  # noqa: F401
