"""Training: optimizer states, schedules, the adaptive GAN weight and the CE
and WGAN-GP train steps."""

from dlsg_tpu_torch.train.gan_lambda import GANLambdaHandler  # noqa: F401
from dlsg_tpu_torch.train.optim import TrainState, make_optimizer, multistep_lr  # noqa: F401
from dlsg_tpu_torch.train.schedule import saving_schedule, scheduled_sampling_epsilon  # noqa: F401
