"""Adversarial losses, port of ``sdface_gan_tpu/losses/gan_losses.py``.

The gradient penalties (R1, path length) take ``torch.autograd.grad`` with
``create_graph=True``, so the penalty stays differentiable with respect to
the network's parameters (the double backward JAX composes natively).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..parallel.mesh import batch_draw, global_mean


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """torch ``F.smooth_l1_loss`` (mean reduction), written out as the JAX one is."""
    diff = torch.abs(pred - target)
    return torch.mean(torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta))


def viewpoints_loss(view_pred: torch.Tensor, view_target: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 between D's viewpoint head and the sampled camera angles."""
    return smooth_l1(view_pred, view_target)


def d_logistic_loss(real_pred: torch.Tensor, fake_pred: torch.Tensor) -> torch.Tensor:
    """Non-saturating logistic D loss."""
    return torch.mean(F.softplus(-real_pred)) + torch.mean(F.softplus(fake_pred))


def g_nonsaturating_loss(fake_pred: torch.Tensor) -> torch.Tensor:
    """Non-saturating G loss."""
    return torch.mean(F.softplus(-fake_pred))


def g_content_loss(fake_img: torch.Tensor, fake_img_up: torch.Tensor) -> torch.Tensor:
    """L1 between the full-res image and the 4x-upsampled thumb."""
    return torch.mean(torch.abs(fake_img_up - fake_img))


def d_logits_and_r1(
    d_fn: Callable[[torch.Tensor], torch.Tensor], real_img: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Real logits AND the R1 penalty (mean per-sample squared gradient norm
    of ``sum(logits)`` with respect to the images) from ONE D forward.  The
    penalty is differentiable with respect to D's parameters."""
    with torch.enable_grad():
        img = real_img.detach().requires_grad_(True)
        logits = d_fn(img)
        (grad,) = torch.autograd.grad(logits.sum(), img, create_graph=True)
    return logits, torch.mean(torch.sum(grad.reshape(grad.shape[0], -1) ** 2, dim=1))


def d_r1_loss(d_fn: Callable[[torch.Tensor], torch.Tensor], real_img: torch.Tensor) -> torch.Tensor:
    """R1 gradient penalty alone."""
    return d_logits_and_r1(d_fn, real_img)[1]


def g_path_regularize(
    img_fn: Callable[[torch.Tensor], torch.Tensor],
    latents: torch.Tensor,
    mean_path_length: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    decay: float = 0.01,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """StyleGAN2 path-length regularizer.

    ``img_fn`` maps the [B, n_latent, D] decoder latents to [B, H, W, 3]
    images.  ``noise`` fixes the projection noise; otherwise it is
    N(0, 1) / sqrt(H W) drawn from ``generator``.  The running mean is
    detached inside the penalty, as the reference does.  Returns
    ``(penalty, new_mean_path_length, path_lengths)``.
    """
    with torch.enable_grad():
        if not latents.requires_grad:
            latents = latents.detach().requires_grad_(True)
        img = img_fn(latents)
        if noise is None:
            h, w = img.shape[1], img.shape[2]
            noise = batch_draw(torch.randn, img.shape, generator, img.device,
                               img.dtype) / math.sqrt(h * w)
        (grad,) = torch.autograd.grad(torch.sum(img * noise), latents, create_graph=True)
    path_lengths = torch.sqrt(torch.mean(torch.sum(grad**2, dim=2), dim=1))
    # the mean over the global batch (inside a data-parallel step, every rank's)
    batch_mean = global_mean(torch.mean(path_lengths))
    path_mean = (mean_path_length + decay * (batch_mean - mean_path_length)).detach()
    penalty = torch.mean((path_lengths - path_mean) ** 2)
    return penalty, path_mean, path_lengths
