"""Models: the CapGnnModel generator and the baseline generators (CapModel,
CapBaselineModel, CapBaseline1), their encoders, decoder and sublayers, and
the DiscV2 discriminator."""

from dlsg_tpu_torch.models.discriminator import DiscV2  # noqa: F401
from dlsg_tpu_torch.models.generator import (  # noqa: F401
    CapBaseline1,
    CapBaselineModel,
    CapGnnModel,
    CapModel,
)
