"""Models: the CapGnnModel generator, its encoders, decoder and sublayers."""

from dlsg_tpu_torch.models.generator import CapGnnModel  # noqa: F401
