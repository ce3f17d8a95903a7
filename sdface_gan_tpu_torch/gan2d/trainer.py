"""gan2d trainer, port of ``sdface_gan_tpu/gan2d/trainer.py``: GIRAFFE's BCE +
R1 D step and BCE G step with the EMA at 0.999, over the 2D ResNet
generator, whose tanh images are brought to [0, 1] (``* 0.5 + 0.5``) to
meet the reals.  Each step draws its N(0, 1) codes from an explicit
``torch.Generator`` (:func:`sample_z`) and takes a loss of given codes."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..giraffe.discriminator import DCDiscriminator
from ..giraffe.trainer import Metrics, compute_bce, d_loss, detached, frozen, update
from ..training.ema import accumulate
from .generator import Gan2dGenerator


@dataclass(frozen=True)
class Gan2dTrainHParams:
    batch_size: int = 32
    lr_g: float = 0.0005
    lr_d: float = 0.0001
    reg_param: float = 10.0
    ema_beta: float = 0.999


def sample_z(generator: torch.Generator, batch_size: int, z_dim: int, device=None) -> torch.Tensor:
    return torch.randn((batch_size, z_dim), generator=generator).to(device)


def gan2d_fake(g: Gan2dGenerator, z: torch.Tensor) -> torch.Tensor:
    """The generator's images in [0, 1], as the reals."""
    return g(z) * 0.5 + 0.5


def gan2d_d_loss(g: Gan2dGenerator, d: DCDiscriminator, hp: Gan2dTrainHParams,
                 x_real: torch.Tensor, z: torch.Tensor) -> Tuple[torch.Tensor, Metrics]:
    with torch.no_grad():
        fake = gan2d_fake(g, z)
    return d_loss(d, x_real, fake, hp.reg_param)


def gan2d_g_loss(g: Gan2dGenerator, d: DCDiscriminator,
                 z: torch.Tensor) -> Tuple[torch.Tensor, Metrics]:
    loss = compute_bce(d(gan2d_fake(g, z))[0], 1.0)
    return loss, {"generator": loss}


def gan2d_d_step(g, d, d_opt, hp: Gan2dTrainHParams, x_real: torch.Tensor,
                 z: torch.Tensor) -> Metrics:
    loss, metrics = gan2d_d_loss(g, d, hp, x_real, z)
    update(d_opt, d, loss)
    return detached(metrics)


def gan2d_g_step(g, d, g_opt, g_ema, hp: Gan2dTrainHParams, z: torch.Tensor) -> Metrics:
    with frozen(d):
        loss, metrics = gan2d_g_loss(g, d, z)
        update(g_opt, g, loss)
    accumulate(g_ema, g, hp.ema_beta)
    return detached(metrics)
