"""GIRAFFE compositional-NeRF generator, port of ``sdface_gan_tpu/giraffe/generator.py``.

Latent codes for the objects and the background, cameras on the view
sphere, per-object box transforms, each object's field and the
background's over the rays of a 16^2 feature map, density composition
(sum or max), volume weights, and the neural renderer up to the image.

Randomness: every sampler draws from an explicit ``torch.Generator`` on
the CPU and maps the draws deterministically (``*_from_*``), so a seed
gives the same scene on every device.  :func:`giraffe_forward` draws what
the caller did not give, in the order object existence, codes, camera,
transforms, background rotation, then (``mode="training"``) the depth
jitter and the density noise (:func:`sample_render_noise`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .bbox import BBoxConfig, Transforms, sample_transformations, transform_points_to_box
from .camera import (
    arange_pixels,
    get_camera_mat,
    get_camera_pose,
    get_random_pose,
    image_points_to_world,
    origin_to_world,
)
from .decoder import DecoderConfig, GiraffeDecoder, SmallDecoder, SmallDecoderConfig
from .neural_renderer import NeuralRenderer, NeuralRendererConfig

Cameras = Tuple[torch.Tensor, torch.Tensor]

# CLEVR-2345's object-count probabilities for 2..5 objects (reference
# ``generator.py:382-415``)
CLEVR_COUNT_PROBS = (0.19456788, 0.24355003, 0.25269547, 0.30918661)
BOX_PADDING = 0.1  # the field is kept inside [-1.1, 1.1]^3 of each box


@dataclass(frozen=True)
class GiraffeConfig:
    z_dim: int = 256
    z_dim_bg: int = 128
    range_u: Tuple[float, float] = (0.0, 0.0)
    range_v: Tuple[float, float] = (0.25, 0.25)
    range_radius: Tuple[float, float] = (2.732, 2.732)
    depth_range: Tuple[float, float] = (0.5, 6.0)
    n_ray_samples: int = 64
    resolution_vol: int = 16
    fov: float = 49.13
    bg_rotation_range: Tuple[float, float] = (0.0, 0.0)
    use_max_composition: bool = False
    sample_object_existance: bool = False
    small_decoder: bool = False
    decoder: DecoderConfig = field(default_factory=lambda: DecoderConfig(z_dim=256))
    small: SmallDecoderConfig = field(default_factory=lambda: SmallDecoderConfig(z_dim=256))
    background: DecoderConfig = field(default_factory=lambda: DecoderConfig(
        z_dim=128, hidden_size=64, n_blocks=4, skips=(), downscale_p_by=12.0))
    bbox: BBoxConfig = field(default_factory=BBoxConfig)
    neural_renderer: Optional[NeuralRendererConfig] = field(
        default_factory=NeuralRendererConfig)

    @property
    def n_boxes(self) -> int:
        return self.bbox.n_boxes


class LatentCodes(NamedTuple):
    z_shape_obj: torch.Tensor  # [B, n_boxes, z_dim]
    z_app_obj: torch.Tensor  # [B, n_boxes, z_dim]
    z_shape_bg: torch.Tensor  # [B, z_dim_bg]
    z_app_bg: torch.Tensor  # [B, z_dim_bg]


class GiraffeGenerator(nn.Module):
    """The parameters: ``decoder`` (:class:`GiraffeDecoder`, or
    :class:`SmallDecoder` with ``small_decoder``), ``background`` and
    ``neural_renderer`` (absent when the config has none), drawn from
    ``generator`` (seed 0 when None) on the CPU."""

    def __init__(self, cfg: GiraffeConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.decoder = (SmallDecoder(cfg.small, generator) if cfg.small_decoder
                        else GiraffeDecoder(cfg.decoder, generator))
        self.background = GiraffeDecoder(cfg.background, generator)
        if cfg.neural_renderer is not None:
            self.neural_renderer = NeuralRenderer(cfg.neural_renderer, generator)


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def sample_latent_codes(generator: torch.Generator, cfg: GiraffeConfig, batch_size: int,
                        tmp: float = 1.0, device=None) -> LatentCodes:
    """N(0, tmp^2) codes for ``cfg.n_boxes`` objects and the background."""
    n = cfg.n_boxes
    shapes = ((batch_size, n, cfg.z_dim), (batch_size, n, cfg.z_dim),
              (batch_size, cfg.z_dim_bg), (batch_size, cfg.z_dim_bg))
    return LatentCodes(*(tmp * torch.randn(s, generator=generator).to(device) for s in shapes))


def sample_random_camera(generator: torch.Generator, cfg: GiraffeConfig, batch_size: int,
                         device=None) -> Cameras:
    world_mat = get_random_pose(generator, cfg.range_u, cfg.range_v, cfg.range_radius,
                                batch_size, device=device)
    return get_camera_mat(cfg.fov, device=device).repeat(batch_size, 1, 1), world_mat


def fixed_camera(cfg: GiraffeConfig, batch_size: int, val_v=0.5, device=None) -> Cameras:
    world_mat = get_camera_pose(cfg.range_u, cfg.range_v, cfg.range_radius, 0.5, val_v, 0.5,
                                batch_size, device=device)
    return get_camera_mat(cfg.fov, device=device).repeat(batch_size, 1, 1), world_mat


def bg_rotation_from_uniform(cfg: GiraffeConfig, u: torch.Tensor,
                             batch_size: int) -> torch.Tensor:
    """The background's rotation about z for a U(0, 1) scalar ``u`` mapped
    into ``bg_rotation_range``, one for the whole batch."""
    r0, r1 = cfg.bg_rotation_range
    a = (r0 + u * (r1 - r0)) * 2.0 * math.pi
    c, s = torch.cos(a), torch.sin(a)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    r = torch.stack([torch.stack([c, -s, zero]), torch.stack([s, c, zero]),
                     torch.stack([zero, zero, one])])
    return r[None].repeat(batch_size, 1, 1)


def sample_bg_rotation(generator: torch.Generator, cfg: GiraffeConfig, batch_size: int,
                       device=None) -> torch.Tensor:
    if cfg.bg_rotation_range == (0.0, 0.0):
        return torch.eye(3, device=device)[None].repeat(batch_size, 1, 1)
    return bg_rotation_from_uniform(cfg, torch.rand((), generator=generator).to(device),
                                    batch_size)


def object_count_probs(cfg: GiraffeConfig) -> torch.Tensor:
    """Probabilities of 2, 3, ... objects: CLEVR's for five boxes, else uniform."""
    n = cfg.n_boxes
    if n == 5:
        return torch.tensor(CLEVR_COUNT_PROBS)
    return torch.ones(max(n - 1, 1)) / max(n - 1, 1)


def object_existence_from_draws(cfg: GiraffeConfig, category: torch.Tensor,
                                scores: torch.Tensor) -> torch.Tensor:
    """Existence mask [B, n_boxes] in {0, 1}: ``2 + category`` objects per
    sample (clipped to n_boxes), those of the highest U(0, 1) ``scores``."""
    counts = torch.clamp(2 + category, 0, cfg.n_boxes)
    rank = torch.argsort(torch.argsort(-scores, dim=-1, stable=True), dim=-1, stable=True)
    return (rank < counts[:, None]).float()


def sample_object_existence(generator: torch.Generator, cfg: GiraffeConfig, batch_size: int,
                            device=None) -> torch.Tensor:
    category = torch.multinomial(object_count_probs(cfg), batch_size, replacement=True,
                                 generator=generator)
    scores = torch.rand((batch_size, cfg.n_boxes), generator=generator)
    return object_existence_from_draws(cfg, category, scores).to(device)


def add_noise_to_interval(di: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Stratified jitter of depths ``di`` [..., S] by U(0, 1) draws ``u``:
    each depth moves within its interval between the midpoints."""
    mid = 0.5 * (di[..., 1:] + di[..., :-1])
    high = torch.cat([mid, di[..., -1:]], -1)
    low = torch.cat([di[..., :1], mid], -1)
    return low + (high - low) * u


def interval_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """The depth jitter's U(0, 1) draws."""
    return torch.rand(shape, generator=generator).to(device)


def density_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """The training density noise's N(0, 1) draws."""
    return torch.randn(shape, generator=generator).to(device)


class RenderNoise(NamedTuple):
    """The draws of a training render: the depth jitter's U(0, 1) [B, N, S]
    and one N(0, 1) density noise [B, N * S] per rendered field, the
    objects in order, then the background."""
    interval: torch.Tensor
    density: Tuple[torch.Tensor, ...]


def sample_render_noise(generator: torch.Generator, cfg: GiraffeConfig, batch_size: int,
                        device=None, not_render_background: bool = False,
                        only_render_background: bool = False) -> RenderNoise:
    n = cfg.resolution_vol ** 2 * cfg.n_ray_samples
    interval = interval_noise(generator, (batch_size, cfg.resolution_vol ** 2,
                                          cfg.n_ray_samples), device)
    n_fields = ((0 if only_render_background else cfg.n_boxes)
                + (0 if not_render_background else 1))
    return RenderNoise(interval, tuple(density_noise(generator, (batch_size, n), device)
                                       for _ in range(n_fields)))


def composite(cfg: GiraffeConfig, sigma: torch.Tensor, feat: torch.Tensor):
    """Density composition across objects: sigma [K, B, N, S], feat [K, B, N,
    S, F].  Sum: densities add and features mix by density (a zero total
    divides by 1e-4).  Max: the densest object's feature, the first on a
    tie (as ``jnp.argmax``)."""
    k = sigma.shape[0]
    if k == 1:
        return sigma[0], feat[0]
    if cfg.use_max_composition:
        smax = sigma.max(dim=0).values
        order = torch.arange(k, device=sigma.device).view(k, 1, 1, 1)
        ind = torch.where(sigma == smax, order, k).min(dim=0).values
        idx = ind[None, ..., None].expand((1,) + ind.shape + (feat.shape[-1],))
        return smax, torch.gather(feat, 0, idx)[0]
    denom = torch.sum(sigma, dim=0, keepdim=True)
    denom = torch.where(denom == 0.0, 1e-4, denom)
    w = sigma / denom
    return torch.sum(sigma, dim=0), torch.sum(feat * w[..., None], dim=0)


def calc_volume_weights(z_vals: torch.Tensor, ray_vector: torch.Tensor, sigma: torch.Tensor,
                        last_dist: float = 1e10) -> torch.Tensor:
    """Alpha-compositing weights; z_vals / sigma [B, N, S], rays [B, N, 3]."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(z_vals[..., :1], last_dist)], -1)
    dists = dists * torch.linalg.norm(ray_vector, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-F.relu(sigma) * dists)
    trans = torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1)
    return alpha * torch.cumprod(trans, dim=-1)[..., :-1]


def volume_render_image(
    g: GiraffeGenerator,
    cfg: GiraffeConfig,
    latent_codes: LatentCodes,
    camera_matrices: Cameras,
    transformations: Transforms,
    bg_rotation: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    mode: str = "training",
    not_render_background: bool = False,
    only_render_background: bool = False,
    return_alpha_map: bool = False,
    object_mask: Optional[torch.Tensor] = None,
    noise: Optional[RenderNoise] = None,
):
    """The feature map [B, res, res, F] (channel-last), and the per-object
    alpha maps [B, res, res, K - 1] with ``return_alpha_map``.  In
    ``mode="training"`` with ``noise`` (drawn from ``generator`` when not
    given), the depths are jittered and N(0, 1) noise is added to each
    density.  ``object_mask`` [B, n_boxes] zeroes the density of masked
    objects."""
    res, n_steps = cfg.resolution_vol, cfg.n_ray_samples
    n_points = res * res
    batch_size = latent_codes.z_shape_obj.shape[0]
    device = latent_codes.z_shape_obj.device
    training = mode == "training" and (generator is not None or noise is not None)
    if training and noise is None:
        noise = sample_render_noise(generator, cfg, batch_size, device, not_render_background,
                                    only_render_background)
    density = iter(noise.density) if training else None

    pixels = arange_pixels(res, batch_size, device=device)
    pixels_world = image_points_to_world(pixels, *camera_matrices)
    camera_world = origin_to_world(n_points, *camera_matrices)
    ray_vector = pixels_world - camera_world

    d0, d1 = cfg.depth_range
    di = d0 + torch.linspace(0.0, 1.0, n_steps, device=device).reshape(1, 1, -1) * (d1 - d0)
    di = di.repeat(batch_size, n_points, 1)
    if training:
        di = add_noise_to_interval(di, noise.interval)

    n_boxes = 0 if only_render_background else cfg.n_boxes
    feats, sigmas = [], []
    s, t, r = transformations

    def march(cam, ray):
        pts = cam[:, :, None, :] + di[..., None] * ray[:, :, None, :]
        rays = ray[:, :, None, :].expand(pts.shape)
        return pts.reshape(batch_size, -1, 3), rays.reshape(batch_size, -1, 3)

    for i in range(n_boxes):
        c_local = transform_points_to_box(camera_world, s, t, r, i)
        ray_i = transform_points_to_box(pixels_world, s, t, r, i) - c_local
        p_flat, r_flat = march(c_local, ray_i)
        feat_i, sigma_i = g.decoder(p_flat, r_flat, latent_codes.z_shape_obj[:, i],
                                    latent_codes.z_app_obj[:, i])
        if training:
            sigma_i = sigma_i + next(density)
        lim = 1.0 + BOX_PADDING
        inside = torch.all((p_flat <= lim) & (p_flat >= -lim), dim=-1)
        sigma_i = torch.where(inside, sigma_i, 0.0)
        if object_mask is not None:
            sigma_i = sigma_i * object_mask[:, i][:, None]
        sigmas.append(sigma_i.reshape(batch_size, n_points, n_steps))
        feats.append(feat_i.reshape(batch_size, n_points, n_steps, -1))

    if not not_render_background:
        cam_bg = torch.einsum("bij,bnj->bni", bg_rotation, camera_world)
        ray_bg = torch.einsum("bij,bnj->bni", bg_rotation, pixels_world) - cam_bg
        p_bg, r_bg = march(cam_bg, ray_bg)
        feat_bg, sigma_bg = g.background(p_bg, r_bg, latent_codes.z_shape_bg,
                                         latent_codes.z_app_bg)
        if training:
            sigma_bg = sigma_bg + next(density)
        sigmas.append(sigma_bg.reshape(batch_size, n_points, n_steps))
        feats.append(feat_bg.reshape(batch_size, n_points, n_steps, -1))

    sigma = F.relu(torch.stack(sigmas, 0))
    feat = torch.stack(feats, 0)
    sigma_sum, feat_weighted = composite(cfg, sigma, feat)
    weights = calc_volume_weights(di, ray_vector, sigma_sum)
    feat_map = torch.sum(weights[..., None] * feat_weighted, dim=-2)  # [B, N, F]
    # x-major pixels -> [B, x, y, F] -> [B, h(y), w(x), F]
    feat_map = feat_map.reshape(batch_size, res, res, -1).transpose(1, 2)

    if return_alpha_map:
        acc_maps = []
        for i in range(sigma.shape[0] - 1):
            w_obj = calc_volume_weights(di, ray_vector, sigma[i], last_dist=0.0)
            acc_maps.append(torch.sum(w_obj, -1).reshape(batch_size, res, res, 1).transpose(1, 2))
        return feat_map, torch.cat(acc_maps, -1)
    return feat_map


def giraffe_forward(
    g: GiraffeGenerator,
    cfg: GiraffeConfig,
    generator: Optional[torch.Generator] = None,
    batch_size: int = 32,
    latent_codes: Optional[LatentCodes] = None,
    camera_matrices: Optional[Cameras] = None,
    transformations: Optional[Transforms] = None,
    bg_rotation: Optional[torch.Tensor] = None,
    mode: str = "training",
    not_render_background: bool = False,
    only_render_background: bool = False,
    return_alpha_map: bool = False,
    object_mask: Optional[torch.Tensor] = None,
    noise: Optional[RenderNoise] = None,
) -> torch.Tensor:
    """The generator's images [B, img_size, img_size, 3] in [0, 1] (the
    feature map without a neural renderer; the alpha maps with
    ``return_alpha_map``).  What is not given is drawn from ``generator``;
    without one the background is not rotated and a ``mode="training"``
    render is noised only by a given ``noise``."""
    device = _device(g)
    if generator is None and None in (latent_codes, camera_matrices, transformations):
        raise ValueError("giraffe_forward draws the codes, camera and transforms not given "
                         "from a torch.Generator: pass one")
    if object_mask is None and cfg.sample_object_existance and generator is not None:
        b = latent_codes.z_shape_obj.shape[0] if latent_codes is not None else batch_size
        object_mask = sample_object_existence(generator, cfg, b, device)
    if latent_codes is None:
        latent_codes = sample_latent_codes(generator, cfg, batch_size, device=device)
    batch_size = latent_codes.z_shape_obj.shape[0]
    if camera_matrices is None:
        camera_matrices = sample_random_camera(generator, cfg, batch_size, device)
    if transformations is None:
        transformations = sample_transformations(generator, cfg.bbox, batch_size, device=device)
    if bg_rotation is None:
        bg_rotation = (sample_bg_rotation(generator, cfg, batch_size, device)
                       if generator is not None
                       else torch.eye(3, device=device)[None].repeat(batch_size, 1, 1))

    if return_alpha_map:
        _, alpha = volume_render_image(
            g, cfg, latent_codes, camera_matrices, transformations, bg_rotation,
            generator=generator, mode=mode, return_alpha_map=True,
            not_render_background=not_render_background, object_mask=object_mask, noise=noise)
        return alpha
    feat_map = volume_render_image(
        g, cfg, latent_codes, camera_matrices, transformations, bg_rotation,
        generator=generator, mode=mode, not_render_background=not_render_background,
        only_render_background=only_render_background, object_mask=object_mask, noise=noise)
    if cfg.neural_renderer is not None and hasattr(g, "neural_renderer"):
        return g.neural_renderer(feat_map)
    return feat_map
