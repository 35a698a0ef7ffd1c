"""Models: the CapGnnModel generator, its encoders, decoder and sublayers, and
the DiscV2 discriminator."""

from dlsg_tpu_torch.models.discriminator import DiscV2  # noqa: F401
from dlsg_tpu_torch.models.generator import CapGnnModel  # noqa: F401
