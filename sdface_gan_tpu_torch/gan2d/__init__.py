"""The plain 2D GAN baseline family, port of ``sdface_gan_tpu/gan2d``: the
GAN-stability ResNet generator, GIRAFFE's DC discriminator, BCE + R1 steps
with RMSprop and the EMA, and the loop (``train --sdf 0`` on a yaml with
``method: gan2d``)."""

from .generator import Gan2dGenerator, Gan2dGeneratorConfig
from .trainer import Gan2dTrainHParams, gan2d_d_step, gan2d_g_step

__all__ = [
    "Gan2dGeneratorConfig",
    "Gan2dGenerator",
    "Gan2dTrainHParams",
    "gan2d_d_step",
    "gan2d_g_step",
]
