"""Host-side data pipeline: HDF5/pickle readers, batching, host -> device
prefetch, synthetic data (counterpart of `dlsg_tpu/data`)."""

from dlsg_tpu_torch.data.datasets import CaptionDataset, EvalVideoDataset  # noqa: F401
from dlsg_tpu_torch.data.loader import eval_batches, train_batches  # noqa: F401
