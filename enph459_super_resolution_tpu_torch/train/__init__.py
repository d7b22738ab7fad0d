"""Training: losses, EMA, train state and steps (plain and ESRGAN
two-player), the data pipeline, VGG19 features, checkpoints, the
``train.loop`` / ``train.evaluate`` CLIs and the burst trainer."""

from .losses import (
    PIXEL_LOSSES,
    PerceptualLoss,
    charbonnier_loss,
    gradient_feature_fn,
    l1_loss,
    l2_loss,
    psnr,
    ragan_discriminator_loss,
    ragan_generator_loss,
)
from .state import (
    GANBalance,
    GANTrainState,
    TrainConfig,
    TrainState,
    ema_update,
    make_gan_train_step,
    make_optimizer,
    make_train_step,
)
from .vgg import VGG19Features, load_torch_vgg19, make_vgg_feature_fn

__all__ = [
    "PIXEL_LOSSES", "PerceptualLoss", "charbonnier_loss",
    "gradient_feature_fn", "l1_loss", "l2_loss", "psnr",
    "ragan_discriminator_loss", "ragan_generator_loss",
    "GANBalance", "GANTrainState", "TrainConfig", "TrainState", "ema_update",
    "make_gan_train_step", "make_optimizer", "make_train_step",
    "VGG19Features", "load_torch_vgg19", "make_vgg_feature_fn",
]
