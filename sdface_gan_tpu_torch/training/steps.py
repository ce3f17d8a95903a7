"""Train steps of the SDF stages, port of ``sdface_gan_tpu/training/steps.py``.

* sphere init - L1-regress the SDF to a centered sphere;
* stage A D / G - the volume renderer against the CoordConv D, with R1
  (every step, or lazily every ``a_d_reg_every``), viewpoint, eikonal and
  minimal-surface terms (and the optional sparsity and distortion priors,
  and for the NGP field the hash-grid smoothness);
* stage B D / G / path - the StyleGAN2 decoder against the StyleGAN2 D,
  with lazy R1 every ``d_reg_every``, the content loss and path-length
  regularization every ``g_reg_every``.

Each step is split in two.  :func:`sample_inputs` draws what the JAX step
draws from its key: z (in stage B also the style-mixing code and injection
index) and the cameras, from one ``torch.Generator``, which the forward then
also uses for the depth jitter, decoder noise, eikonal points and path
noise.  ``StepInputs(generator=None)`` is deterministic (fixed depths, the
stored decoder noise; the path step then needs ``path_noise``, the
subsampled eikonal ``eikonal_draws``, the NGP smoothness ``smooth_draws``), so tests
can feed the JAX package and the port the same inputs.  The ``*_loss``
functions compute a loss and its metrics from the inputs; the ``*_step``
functions take the gradients of the optimizer's parameters (zero where a
parameter is unused, as optax sees it), step the optimizer and, in the
stage-A G step, fold the EMA.

``g_param_dtype`` casts the generator's parameters inside the loss (the
fake forward of the D steps included) and not with autocast: the cast is
differentiable, so gradients, optimizer state and EMA stay f32.  Stage B
does not fold the EMA in its G step: the loop does, after the path step.

Over a data-parallel ``mesh`` (:mod:`..parallel`) each rank holds its rows
of the global batch: :func:`sample_inputs` draws at the global batch and
keeps the rank's rows, the step runs inside ``over(mesh)`` (the draws in the
forward, the D's minibatch stddev and the path-length mean then take the
global batch) and ``_step`` averages the gradients over the ranks, so that a
W-rank step computes what one rank computes at the same global batch, as
JAX's global program does.  ``mesh=None`` is the single-process step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import chain
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..geometry.cameras import CameraParams, generate_camera_params
from ..losses.gan_losses import (
    d_logistic_loss,
    d_logits_and_r1,
    g_content_loss,
    g_nonsaturating_loss,
    g_path_regularize,
    viewpoints_loss,
)
from ..losses.geometry_losses import (
    distortion_loss,
    eikonal_loss,
    hash_smoothness_loss,
    occupancy_sparsity_loss,
    sphere_init_loss,
)
from ..models.discriminator import StyleDiscConfig, VolumeRenderDiscConfig
from ..models.generator import (
    GeneratorConfig,
    generator_forward,
    generator_init_forward,
    map_style,
)
from ..models.renderer import render
from ..models.stylegan2 import apply_decoder, make_decoder_latent
from ..parallel.mesh import Mesh, all_reduce_grads, over, shard_batch
from ..utils.functional import call_with
from .ema import EMA_DECAY, accumulate

Metrics = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class CameraHParams:
    """Camera sampling knobs (reference ``sdf_utils.py:560-575``)."""

    uniform: bool = False
    azim: float = 0.3
    elev: float = 0.15
    fov: float = 6.0
    dist_radius: float = 0.12


@dataclass(frozen=True)
class TrainHParams:
    """Training hyperparameters (reference ``sdf_utils.py:447-530``); the
    fields of the JAX package's ``TrainHParams``."""

    batch: int = 8
    style_dim: int = 256
    r1: float = 10.0
    view_lambda: float = 15.0
    eikonal_lambda: float = 0.1
    min_surf_lambda: float = 0.05
    min_surf_beta: float = 100.0
    sparsity_lambda: float = 0.0
    distortion_lambda: float = 0.0
    smooth_lambda: float = 1000.0
    # "bfloat16": the G forwards run on parameters cast inside the loss
    g_param_dtype: str = "float32"
    mixing: float = 0.9
    d_reg_every: int = 16
    g_reg_every: int = 4
    a_d_reg_every: int = 1
    path_regularize: float = 2.0
    path_batch_shrink: int = 2
    camera: CameraHParams = field(default_factory=CameraHParams)


# The stage-A hash-grid smoothness box (axis-aligned min/max), reference
# ``training_utils.py:433-437``: NGP training samples its TV grid in it.
SMOOTH_BBOX = ((-1.0, 7.0), (-1.3, 3.7), (-1.7, 1.4))


class StepInputs(NamedTuple):
    """What one step draws: z [B, style_dim], the cameras, in stage B the
    mixing code z2 (z itself when unmixed) and the injection index (a 0-d
    tensor or an int), and the generator the forward draws from (None:
    deterministic).  ``path_noise`` fixes the path step's projection noise,
    ``eikonal_draws`` the subsampled eikonal points (``render``) and
    ``smooth_draws`` the NGP smoothness grid's offset and jitter
    (``hash_smoothness_loss``)."""

    z: torch.Tensor
    cams: CameraParams
    z2: Optional[torch.Tensor] = None
    inject_index: Optional[Any] = None
    generator: Optional[torch.Generator] = None
    path_noise: Optional[torch.Tensor] = None
    eikonal_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    smooth_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


def sample_inputs(
    hp: TrainHParams,
    res: int,
    batch: int,
    generator: torch.Generator,
    n_latent: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> StepInputs:
    """Draw a step's inputs on the generator's device.  With ``n_latent``
    (stage B) also style mixing: with probability ``hp.mixing`` a second
    code and an injection index in [1, n_latent), else z itself and
    ``n_latent`` (every layer takes z), drawn without a host sync.  Over a
    ``mesh``, ``batch`` is the global batch and the rank keeps its rows."""
    device = generator.device
    z = torch.randn((batch, hp.style_dim), generator=generator, device=device)
    z2 = idx = None
    if n_latent is not None:
        other = torch.randn((batch, hp.style_dim), generator=generator, device=device)
        mixed = torch.rand((), generator=generator, device=device) < hp.mixing
        z2 = torch.where(mixed, other, z)
        idx = torch.where(mixed, torch.randint(1, n_latent, (), generator=generator,
                                               device=device),
                          torch.tensor(n_latent, device=device))
    cam = hp.camera
    cams = generate_camera_params(res, generator, batch=batch, uniform=cam.uniform,
                                  azim_range=cam.azim, elev_range=cam.elev, fov_ang=cam.fov,
                                  dist_radius=cam.dist_radius, device=device)
    return shard_batch(StepInputs(z, cams, z2, idx, generator), mesh)


def _param_dtype(hp: TrainHParams) -> Optional[torch.dtype]:
    return None if hp.g_param_dtype == "float32" else getattr(torch, hp.g_param_dtype)


def forward_cast(model: nn.Module, dtype: Optional[torch.dtype], fn: Callable, *args,
                 **kwargs):
    """``fn(model, *args, **kwargs)`` with the model's floating parameters
    and buffers cast to ``dtype`` for this call (``None``: as they are).
    The casts are differentiable: gradients reach the f32 parameters in f32."""
    if dtype is None:
        return fn(model, *args, **kwargs)
    tensors = {name: t.to(dtype) if t.is_floating_point() else t
               for name, t in chain(model.named_parameters(), model.named_buffers())}
    return call_with(model, tensors, fn, *args, **kwargs)


def _step(opt: torch.optim.Optimizer, loss: torch.Tensor, mesh: Optional[Mesh] = None,
          op: str = "mean") -> None:
    """One optimizer step on the gradients of ``loss`` with respect to the
    optimizer's parameters alone (zeros for unused ones), averaged over the
    ranks of ``mesh`` (summed with ``op="sum"``, for a loss summed over
    the batch)."""
    params = [p for group in opt.param_groups for p in group["params"]]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    for p, g in zip(params, all_reduce_grads(grads, mesh, op)):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def _detached(metrics: Metrics) -> Metrics:
    return {k: v.detach() for k, v in metrics.items()}


def _cam_args(cams: CameraParams):
    return cams.extrinsics, cams.focal, cams.near, cams.far


# ---------------------------------------------------------------------------
# Sphere init
# ---------------------------------------------------------------------------

def sphere_init_loss_fn(g: nn.Module, gcfg: GeneratorConfig, hp: TrainHParams,
                        inputs: StepInputs) -> Tuple[torch.Tensor, Metrics]:
    """``L1(sdf, ||p|| - (far - near) / 4)`` through the sphere-init pass."""
    sdf, target = generator_init_forward(g, gcfg, [inputs.z], *_cam_args(inputs.cams),
                                         generator=inputs.generator)
    loss = sphere_init_loss(sdf, target)
    return loss, {"sdf_init_loss": loss.detach()}


def sphere_init_step(g, g_opt, gcfg, hp, inputs) -> Metrics:
    loss, metrics = sphere_init_loss_fn(g, gcfg, hp, inputs)
    _step(g_opt, loss)
    return metrics


# ---------------------------------------------------------------------------
# Stage A: the volume renderer against the CoordConv D
# ---------------------------------------------------------------------------

def stage_a_d_loss(
    g: nn.Module, d: nn.Module, gcfg: GeneratorConfig, dcfg: VolumeRenderDiscConfig,
    hp: TrainHParams, real_thumbs: torch.Tensor, inputs: StepInputs, with_r1: bool = True,
) -> Tuple[torch.Tensor, Metrics]:
    """Logistic loss + R1 (weight r1 / 2, times ``a_d_reg_every``) + the
    viewpoint smooth-L1 on detached fakes; ``with_r1=False`` is the plain
    variant of lazy stage-A R1."""
    use_view = hp.view_lambda > 0 and dcfg.viewpoint_head
    cams = inputs.cams
    with torch.no_grad():
        out = forward_cast(g, _param_dtype(hp), generator_forward, gcfg, [inputs.z],
                           *_cam_args(cams), generator=inputs.generator)
    fake_pred, fake_view = d(out.thumb_rgb.float())
    zero = fake_pred.new_zeros(())
    d_view = hp.view_lambda * viewpoints_loss(fake_view, cams.viewpoint) if use_view else zero
    if with_r1:
        real_pred, penalty = d_logits_and_r1(lambda img: d(img)[0], real_thumbs)
        r1 = hp.r1 * 0.5 * penalty * max(hp.a_d_reg_every, 1)
    else:
        real_pred, r1 = d(real_thumbs)[0], zero
    gan = d_logistic_loss(real_pred, fake_pred)
    metrics = {"d": gan, "d_view": d_view, "real_score": torch.mean(real_pred),
               "fake_score": torch.mean(fake_pred)}
    if with_r1:
        metrics["r1"] = r1
    return gan + r1 + d_view, _detached(metrics)


def stage_a_d_step(g, d, d_opt, gcfg, dcfg, hp, real_thumbs, inputs,
                   with_r1: bool = True, mesh: Optional[Mesh] = None) -> Metrics:
    with over(mesh):
        loss, metrics = stage_a_d_loss(g, d, gcfg, dcfg, hp, real_thumbs, inputs, with_r1)
        _step(d_opt, loss, mesh)
    return metrics


def stage_a_g_loss(
    g: nn.Module, d: nn.Module, gcfg: GeneratorConfig, dcfg: VolumeRenderDiscConfig,
    hp: TrainHParams, inputs: StepInputs,
) -> Tuple[torch.Tensor, Metrics]:
    """Nonsaturating + viewpoint + eikonal + minimal surface (+ sparsity and
    distortion when their weights are > 0, and the NGP field's hash-grid
    smoothness on its f32 master table, uncast, as the JAX step feeds it)."""
    use_eik, use_msurf = hp.eikonal_lambda > 0, hp.min_surf_lambda > 0
    use_sparsity, use_dist = hp.sparsity_lambda > 0, hp.distortion_lambda > 0
    use_view = hp.view_lambda > 0 and dcfg.viewpoint_head
    cams = inputs.cams
    out = forward_cast(g, _param_dtype(hp), generator_forward, gcfg, [inputs.z],
                       *_cam_args(cams), generator=inputs.generator,
                       return_sdf=use_msurf or use_sparsity, return_xyz=True,
                       return_eikonal=use_eik, return_weights=use_dist,
                       eikonal_draws=inputs.eikonal_draws)
    fake_pred, fake_view = d(out.thumb_rgb)
    g_gan = g_nonsaturating_loss(fake_pred)
    g_view = (hp.view_lambda * viewpoints_loss(fake_view, cams.viewpoint) if use_view
              else fake_pred.new_zeros(()))
    eik, msurf = eikonal_loss(out.eikonal_term if use_eik else None,
                              out.sdf if use_msurf else None, beta=hp.min_surf_beta)
    loss = g_gan + g_view + hp.eikonal_lambda * eik + hp.min_surf_lambda * msurf
    metrics = {"g": g_gan, "g_view": g_view, "g_eikonal": hp.eikonal_lambda * eik,
               "g_minimal_surface": hp.min_surf_lambda * msurf,
               # compositing weight inside the volume rather than on the
               # background sample: a collapse to a billboard drives it to 0
               "fg_mass": 1.0 - torch.mean(out.mask)}
    if use_sparsity:
        sparsity = occupancy_sparsity_loss(out.sdf, g.renderer.sigmoid_beta)
        loss = loss + hp.sparsity_lambda * sparsity
        metrics["g_sparsity"] = hp.sparsity_lambda * sparsity
    if use_dist:
        dist = distortion_loss(out.weights, out.s_vals)
        loss = loss + hp.distortion_lambda * dist
        metrics["g_distortion"] = hp.distortion_lambda * dist
    if gcfg.renderer.type == "ngp" and hp.smooth_lambda > 0:
        net = g.renderer.network
        smooth = hash_smoothness_loss(net.encoder.embeddings, net.cfg.grid, SMOOTH_BBOX,
                                      bound=net.cfg.bound, generator=inputs.generator,
                                      draws=inputs.smooth_draws)
        loss = loss + hp.smooth_lambda * smooth
        metrics["g_smooth"] = hp.smooth_lambda * smooth
    return loss, _detached(metrics)


def stage_a_g_step(g, d, g_opt, g_ema, gcfg, dcfg, hp, inputs,
                   ema_decay: float = EMA_DECAY, mesh: Optional[Mesh] = None) -> Metrics:
    with over(mesh):
        loss, metrics = stage_a_g_loss(g, d, gcfg, dcfg, hp, inputs)
        _step(g_opt, loss, mesh)
    accumulate(g_ema, g, ema_decay)
    return metrics


# ---------------------------------------------------------------------------
# Stage B: the decoder against the StyleGAN2 D
# ---------------------------------------------------------------------------

def _mixed_forward(g, gcfg, hp, inputs, **kw):
    return forward_cast(g, _param_dtype(hp), generator_forward, gcfg, [inputs.z, inputs.z2],
                        *_cam_args(inputs.cams), generator=inputs.generator,
                        inject_index=inputs.inject_index, **kw)


def stage_b_d_loss(
    g: nn.Module, d: nn.Module, gcfg: GeneratorConfig, dcfg: StyleDiscConfig,
    hp: TrainHParams, real_imgs: torch.Tensor, inputs: StepInputs, regularize: bool,
) -> Tuple[torch.Tensor, Metrics]:
    """Logistic loss on detached fakes; on ``regularize`` iterations R1 with
    weight r1 / 2 times ``d_reg_every`` (lazy regularization)."""
    with torch.no_grad():
        out = _mixed_forward(g, gcfg, hp, inputs)
    fake_pred = d(out.rgb.float())
    if regularize:
        real_pred, penalty = d_logits_and_r1(d, real_imgs)
    else:
        real_pred = d(real_imgs)
    gan = d_logistic_loss(real_pred, fake_pred)
    metrics = {"d": gan, "real_score": torch.mean(real_pred),
               "fake_score": torch.mean(fake_pred)}
    loss = gan
    if regularize:
        r1 = hp.r1 * 0.5 * penalty * hp.d_reg_every
        loss = loss + r1
        metrics["r1"] = r1
    return loss, _detached(metrics)


def stage_b_d_step(g, d, d_opt, gcfg, dcfg, hp, real_imgs, inputs, regularize,
                   mesh: Optional[Mesh] = None) -> Metrics:
    with over(mesh):
        loss, metrics = stage_b_d_loss(g, d, gcfg, dcfg, hp, real_imgs, inputs, regularize)
        _step(d_opt, loss, mesh)
    return metrics


def _nearest_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """torch ``nn.Upsample(scale_factor=f)`` (nearest) on [B, H, W, C]."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


def stage_b_g_loss(
    g: nn.Module, d: nn.Module, gcfg: GeneratorConfig, dcfg: StyleDiscConfig,
    hp: TrainHParams, inputs: StepInputs, content_lambda: float = 0.001,
) -> Tuple[torch.Tensor, Metrics]:
    """Nonsaturating + content loss against the 4x-nearest-upsampled thumb."""
    out = _mixed_forward(g, gcfg, hp, inputs)
    g_gan = g_nonsaturating_loss(d(out.rgb))
    cont = g_content_loss(out.rgb, _nearest_upsample(out.thumb_rgb,
                                                     gcfg.size // gcfg.renderer.out_im_res))
    return g_gan + content_lambda * cont, _detached({"g": g_gan, "g_content": cont})


def stage_b_g_step(g, d, g_opt, gcfg, dcfg, hp, inputs, mesh: Optional[Mesh] = None) -> Metrics:
    with over(mesh):
        loss, metrics = stage_b_g_loss(g, d, gcfg, dcfg, hp, inputs)
        _step(g_opt, loss, mesh)
    return metrics


def stage_b_path_loss(
    g: nn.Module, gcfg: GeneratorConfig, hp: TrainHParams, inputs: StepInputs,
    mean_path_length: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, Metrics]:
    """Path-length penalty (times ``path_regularize * g_reg_every``) of the
    decoder on the frozen renderer's features, f32, on the inputs' batch
    (``batch // path_batch_shrink`` in the loop).  Returns ``(loss,
    new_mean_path_length, metrics)``."""
    dcfg = gcfg.decoder
    gen = inputs.generator
    cams = inputs.cams
    with torch.no_grad():
        features = render(g.renderer, gcfg.renderer, cams.focal, cams.extrinsics, cams.near,
                          cams.far, map_style(g, inputs.z), generator=gen).features
    latent = make_decoder_latent(g.decoder, dcfg, [map_style(g, inputs.z),
                                                   map_style(g, inputs.z2)],
                                 inject_index=inputs.inject_index)
    penalty, new_mean, path_lengths = g_path_regularize(
        lambda lat: apply_decoder(g.decoder, dcfg, features, lat, generator=gen),
        latent, mean_path_length, generator=gen, noise=inputs.path_noise)
    loss = hp.path_regularize * hp.g_reg_every * penalty
    return loss, new_mean, _detached({"path": penalty,
                                      "path_length": torch.mean(path_lengths)})


def stage_b_path_step(g, g_opt, gcfg, hp, inputs, mean_path_length,
                      mesh: Optional[Mesh] = None):
    """Returns ``(new_mean_path_length, metrics)``."""
    with over(mesh):
        loss, new_mean, metrics = stage_b_path_loss(g, gcfg, hp, inputs, mean_path_length)
        _step(g_opt, loss, mesh)
    return new_mean, metrics
