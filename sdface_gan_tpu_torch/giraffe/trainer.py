"""GIRAFFE trainer, port of ``sdface_gan_tpu/giraffe/trainer.py``: the D step
(BCE(real, 1) + BCE(fake, 0) + 10 * R1), the G step (BCE(fake, 1), then
the EMA at 0.999 over every leaf of G) and the VAE encoder step (summed KL
plus summed discriminator feature matching), with RMSprop or Adam
(``training/optim.giraffe_optimizers``).

Each step is a draw (``sample_*_draws``: an explicit ``torch.Generator``
on the CPU, then deterministic maps) followed by a loss of given inputs
(``*_loss``) and an update.  Each step differentiates only its own module,
as ``jax.value_and_grad`` over one tree does: the other modules are frozen
for the step (the D step renders its fakes without a graph), and the
gradients are taken with ``torch.autograd.grad`` over the module's own
parameters, so no ``.grad`` of another module is filled.  On the card the
hash decoders' table gradient (G step only) runs the hand-written kernel
``hash_encode_backward``; the D and E steps launch none.

Over a data-parallel ``mesh`` each step takes the rank's rows of the reals
and of the draws (made at the global batch), runs inside ``over(mesh)`` (the
VAE's batch statistics then take the global batch) and reduces its
gradients over the ranks: averaged for the D and G losses (batch means),
summed for the E loss (a sum over the batch), as JAX's global program
differentiates them.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..encoder.vae import VAEEncoder, VAEEncoderConfig, reparameterize
from ..parallel.mesh import Mesh, all_reduce_grads, over
from ..training.ema import accumulate
from .bbox import Transforms, sample_transformations
from .discriminator import DCDiscriminator
from .generator import (
    Cameras,
    GiraffeConfig,
    GiraffeGenerator,
    LatentCodes,
    RenderNoise,
    giraffe_forward,
    sample_bg_rotation,
    sample_latent_codes,
    sample_object_existence,
    sample_random_camera,
    sample_render_noise,
)

Metrics = Dict[str, torch.Tensor]


def compute_bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Binary cross entropy with logits against a constant target, the mean."""
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


def compute_grad2(d_out: torch.Tensor, x_in: torch.Tensor) -> torch.Tensor:
    """R1: the batch mean of each sample's summed squared gradient of
    ``sum(d_out)`` with respect to ``x_in``, with its graph (its own
    gradient reaches D's parameters)."""
    grad, = torch.autograd.grad(d_out.sum(), x_in, create_graph=True)
    return grad.pow(2).reshape(grad.shape[0], -1).sum(1).mean()


@dataclass(frozen=True)
class GiraffeTrainHParams:
    batch_size: int = 32
    lr_g: float = 0.0005
    lr_d: float = 0.0001
    reg_param: float = 10.0
    ema_beta: float = 0.999
    optimizer: str = "RMSprop"


@contextlib.contextmanager
def frozen(*modules: nn.Module) -> Iterator[None]:
    """The parameters of ``modules`` do not require grad inside."""
    params = [p for m in modules for p in m.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def update(opt: torch.optim.Optimizer, module: nn.Module, loss: torch.Tensor,
           mesh: Optional[Mesh] = None, op: str = "mean") -> None:
    """One step of ``opt`` on the gradient of ``loss`` over ``module``'s own
    parameters, reduced over the ranks of ``mesh`` by ``op``."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p, g in zip(params, all_reduce_grads(torch.autograd.grad(loss, params), mesh, op)):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


def detached(metrics: Metrics) -> Metrics:
    return {k: v.detach() for k, v in metrics.items()}


# ---------------------------------------------------------------- the draws
class GiraffeDraws(NamedTuple):
    """A training render's inputs, in the order :func:`giraffe_forward`
    draws them: the object mask (None unless the config samples object
    existence), codes, camera, box transforms, background rotation, then
    the render's noise."""
    object_mask: Optional[torch.Tensor]
    latent_codes: LatentCodes
    camera_matrices: Cameras
    transformations: Transforms
    bg_rotation: torch.Tensor
    noise: RenderNoise


def sample_scene_draws(generator: torch.Generator, cfg: GiraffeConfig, batch_size: int,
                       device=None) -> GiraffeDraws:
    """The draws of one training render of ``batch_size`` images."""
    mask = (sample_object_existence(generator, cfg, batch_size, device)
            if cfg.sample_object_existance else None)
    latent_codes = sample_latent_codes(generator, cfg, batch_size, device=device)
    cams = sample_random_camera(generator, cfg, batch_size, device)
    trans = sample_transformations(generator, cfg.bbox, batch_size, device=device)
    bg = sample_bg_rotation(generator, cfg, batch_size, device)
    return GiraffeDraws(mask, latent_codes, cams, trans, bg,
                        sample_render_noise(generator, cfg, batch_size, device))


def render_draws(g: GiraffeGenerator, cfg: GiraffeConfig, draws: GiraffeDraws,
                 latent_codes: Optional[LatentCodes] = None) -> torch.Tensor:
    """The training render [B, H, W, 3] in [0, 1] of ``draws`` (their codes
    replaced by ``latent_codes`` when given)."""
    if latent_codes is None:
        latent_codes = draws.latent_codes
    return giraffe_forward(g, cfg, latent_codes=latent_codes,
                           camera_matrices=draws.camera_matrices,
                           transformations=draws.transformations,
                           bg_rotation=draws.bg_rotation, mode="training",
                           object_mask=draws.object_mask, noise=draws.noise)


class EncoderDraws(NamedTuple):
    """The E step's draws: the reparameterisation's N(0, 1) ``eps`` [B, 2 z],
    then a training render's (whose object codes the encoder replaces)."""
    eps: torch.Tensor
    scene: GiraffeDraws


def encoder_config(cfg: GiraffeConfig, img_size: int) -> VAEEncoderConfig:
    """The VAE of ``--vae 1``: it emits ``[z_shape | z_app]``."""
    return VAEEncoderConfig(img_size=img_size, z_size=2 * cfg.z_dim)


def sample_encoder_draws(generator: torch.Generator, cfg: GiraffeConfig, batch_size: int,
                         device=None) -> EncoderDraws:
    eps = torch.randn((batch_size, 2 * cfg.z_dim), generator=generator).to(device)
    return EncoderDraws(eps, sample_scene_draws(generator, cfg, batch_size, device))


# ------------------------------------------------------------ the losses
def d_loss(d: nn.Module, x_real: torch.Tensor, fake: torch.Tensor,
           reg_param: float) -> Tuple[torch.Tensor, Metrics]:
    """BCE(D(real), 1) + BCE(D(fake), 0) + ``reg_param`` * R1 at the reals;
    ``d`` returns (logits, ...)."""
    x_real = x_real.detach().requires_grad_(True)
    d_real = d(x_real)[0]
    loss_real = compute_bce(d_real, 1.0)
    reg = reg_param * compute_grad2(d_real, x_real)
    loss_fake = compute_bce(d(fake)[0], 0.0)
    return loss_real + loss_fake + reg, {"discriminator": loss_real + loss_fake,
                                         "regularizer": reg}


def giraffe_d_loss(g: GiraffeGenerator, d: DCDiscriminator, cfg: GiraffeConfig,
                   hp: GiraffeTrainHParams, x_real: torch.Tensor,
                   draws: GiraffeDraws) -> Tuple[torch.Tensor, Metrics]:
    with torch.no_grad():
        fake = render_draws(g, cfg, draws)
    return d_loss(d, x_real, fake, hp.reg_param)


def giraffe_g_loss(g: GiraffeGenerator, d: DCDiscriminator, cfg: GiraffeConfig,
                   draws: GiraffeDraws) -> Tuple[torch.Tensor, Metrics]:
    loss = compute_bce(d(render_draws(g, cfg, draws))[0], 1.0)
    return loss, {"generator": loss}


def giraffe_e_loss(e: VAEEncoder, g: GiraffeGenerator, d: DCDiscriminator, cfg: GiraffeConfig,
                   x_real: torch.Tensor, draws: EncoderDraws) -> Tuple[torch.Tensor, Metrics]:
    """Summed KL of the codes of the reals plus the summed
    ``0.5 * (D_feat(real) - D_feat(fake))^2`` of their training render."""
    mu, logvar = e(x_real)
    z = reparameterize(mu, logvar, eps=draws.eps)
    codes = draws.scene.latent_codes._replace(z_shape_obj=z[:, None, :cfg.z_dim],
                                              z_app_obj=z[:, None, cfg.z_dim:])
    _, feat_fake = d(render_draws(g, cfg, draws.scene, latent_codes=codes))
    _, feat_real = d(x_real)
    kl = -0.5 * torch.sum(-torch.exp(logvar) - mu ** 2 + logvar + 1.0, dim=1)
    mse = torch.sum(0.5 * (feat_real - feat_fake) ** 2, dim=1)
    loss = kl.sum() + mse.sum()
    return loss, {"encoder": loss, "e_kl": kl.sum()}


# ------------------------------------------------------------- the steps
def giraffe_d_step(g, d, d_opt, cfg: GiraffeConfig, hp: GiraffeTrainHParams,
                   x_real: torch.Tensor, draws: GiraffeDraws,
                   mesh: Optional[Mesh] = None) -> Metrics:
    with over(mesh):
        loss, metrics = giraffe_d_loss(g, d, cfg, hp, x_real, draws)
        update(d_opt, d, loss, mesh)
    return detached(metrics)


def giraffe_g_step(g, d, g_opt, g_ema, cfg: GiraffeConfig, hp: GiraffeTrainHParams,
                   draws: GiraffeDraws, mesh: Optional[Mesh] = None) -> Metrics:
    """The G update, then ``g_ema <- beta * g_ema + (1 - beta) * g``."""
    with frozen(d), over(mesh):
        loss, metrics = giraffe_g_loss(g, d, cfg, draws)
        update(g_opt, g, loss, mesh)
    accumulate(g_ema, g, hp.ema_beta)
    return detached(metrics)


def giraffe_e_step(e, g, d, e_opt, cfg: GiraffeConfig, x_real: torch.Tensor,
                   draws: EncoderDraws, mesh: Optional[Mesh] = None) -> Metrics:
    """The E update.  Its metrics are sums over the batch: over a mesh each
    rank's is scaled by the world, so that their mean over the ranks (the
    loops' logging) is the global sum."""
    with frozen(g, d), over(mesh):
        loss, metrics = giraffe_e_loss(e, g, d, cfg, x_real, draws)
        update(e_opt, e, loss, mesh, op="sum")
    if mesh is not None and mesh.distributed:
        metrics = {k: v * mesh.world for k, v in metrics.items()}
    return detached(metrics)
