"""SDF volume feature renderer, port of ``sdface_gan_tpu/models/renderer.py``.

camera rays -> depth samples -> field (FiLM-SIREN, NGP hash grid or FC)
-> SDF-to-density -> alpha compositing -> 64x64 thumb RGB and feature map.
Layout is channel-last ([B, H, W, C] and [B, H, W, S, C]) as in the JAX
package.  Compositing runs in f32 whatever the field's dtype.

Training: ``render(..., return_eikonal=True)`` adds d sdf / d world points
(``torch.autograd.grad`` with ``create_graph=True``, so the eikonal loss
is differentiable with respect to the field's parameters), over every
rendered point or at ``eikonal_subsample`` fresh frustum points;
:func:`mlp_init_pass` is the sphere-init regression pass.  Training never
runs the fused SIREN field: it has no backward and refuses tensors that
need a gradient.  The NGP field's encode is differentiable: on the card its
forward, backward and double backward are the hash-grid kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import chain
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..geometry.rays import base_t_vals, get_rays
from ..ops.siren_kernel import (
    SirenFieldPack,
    film_coeffs,
    pack_siren_field,
    siren_field_fused_parts,
)
from ..ops.hash_encoder import HashGridSpec
from ..utils.functional import call_with
from .siren import (
    FCConfig,
    FCGenerator,
    NGPSirenConfig,
    NGPSIRENGenerator,
    SirenConfig,
    SirenGenerator,
)

_BG_LEVEL = {"white": 1.0, "gray": 0.5, "black": 0.0}


@dataclass(frozen=True)
class RendererConfig:
    """Static renderer options (the inference subset of the JAX config)."""

    type: str = "sdf"  # 'sdf' (FiLM-SIREN) | 'ngp' (hash grid) | 'fc' (ReLU MLP)
    out_im_res: int = 64
    n_samples: int = 24
    style_dim: int = 256
    width: int = 256
    depth: int = 8
    offset_sampling: bool = True
    static_viewdirs: bool = False
    z_normalize: bool = True
    with_sdf: bool = True
    force_background: bool = True
    output_features: bool = True
    return_xyz: bool = False
    return_sdf: bool = False
    return_weights: bool = False
    view_independent: bool = False
    perturb: float = 1.0
    raw_noise_std: float = 0.0
    # Evaluate the SIREN field through the port's fused CUDA kernel
    # ('sdf', ops/siren_kernel.py; inference only), as in the JAX package.
    # The NGP field's encode takes the hash-grid kernels on a CUDA tensor
    # (``models.siren.plain_encode`` asks for their plain versions).
    use_fused_kernel: bool = False
    # 'lastsample': the final sample gets an infinite bin (reference
    # semantics); 'white' / 'gray' / 'black' composite leftover visibility
    # onto a fixed color.
    bg_mode: str = "lastsample"
    # NGP hash-grid geometry (type 'ngp' only) and the corner-packed
    # inference tables' budget in MB (0 = off; the sampler packs once).
    ngp_num_levels: int = 16
    ngp_level_dim: int = 2
    ngp_finest_res: int = 4096
    ngp_log2_hashmap_size: int = 19
    ngp_pack_mb: int = 0
    # Recompute the field's activations in the backward pass
    # (``torch.utils.checkpoint``) instead of keeping them from the forward.
    remat: bool = True
    # d sdf / d pts for the eikonal term: 'vjp' (reverse mode, the
    # reference's semantics).  The JAX package's 'jvp' is not ported.
    eikonal_mode: str = "vjp"
    # Eikonal point budget: 0 = every rendered point (reference semantics);
    # M > 0 = M fresh frustum points per batch element (random pixel ray x
    # random depth), so the second-order graph leaves the render graph.
    eikonal_subsample: int = 0

    @property
    def feature_out_size(self) -> int:
        # reference sdf_model.py:191: width unless ngp (then style_dim)
        return self.width if self.type != "ngp" else self.style_dim

    def network_config(self) -> Union[SirenConfig, NGPSirenConfig, FCConfig]:
        if self.type == "ngp":
            return NGPSirenConfig(
                width=self.style_dim, style_dim=self.style_dim,
                output_features=self.output_features,
                grid=HashGridSpec.create(
                    num_levels=self.ngp_num_levels, level_dim=self.ngp_level_dim,
                    desired_resolution=self.ngp_finest_res,
                    log2_hashmap_size=self.ngp_log2_hashmap_size),
                pack_mb=self.ngp_pack_mb)
        if self.type == "fc":
            return FCConfig(depth=self.depth, width=self.width, style_dim=self.style_dim,
                            output_features=self.output_features)
        if self.type != "sdf":
            raise ValueError(f"unknown renderer type {self.type!r}")
        return SirenConfig(depth=self.depth, width=self.width,
                           style_dim=self.style_dim,
                           output_features=self.output_features)


class RenderOutput(NamedTuple):
    rgb: torch.Tensor  # [B, H, W, 3] in [-1, 1]
    features: Optional[torch.Tensor]  # [B, H, W, F]
    sdf: Optional[torch.Tensor]  # [B, H, W, S, 1]
    mask: Optional[torch.Tensor]  # [B, H, W, 1]
    xyz: Optional[torch.Tensor]  # [B, H, W, 3]
    # d sdf / d pts [B, H, W, S, 3] ([B, M, 3] under eikonal_subsample)
    eikonal_term: Optional[torch.Tensor] = None
    weights: Optional[torch.Tensor] = None  # [B, H, W, S]
    s_vals: Optional[torch.Tensor] = None  # [B, H, W, S]


class VolumeFeatureRenderer(nn.Module):
    """Holds the field network and the learnable SDF-to-density beta."""

    def __init__(self, cfg: RendererConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        network = {"ngp": NGPSIRENGenerator, "fc": FCGenerator}.get(cfg.type, SirenGenerator)
        self.network = network(cfg.network_config(), generator=generator)
        if cfg.with_sdf:
            self.sigmoid_beta = nn.Parameter(torch.full((1,), 0.1))


def _apply_network(
    renderer: VolumeFeatureRenderer,
    cfg: RendererConfig,
    pts: torch.Tensor,
    views: torch.Tensor,
    style: torch.Tensor,
    field_pack: Optional[SirenFieldPack] = None,
):
    """Evaluate the field on [B, H, W, S, 3] inputs over one flat point axis.

    Returns ``(rgb, sdf, features | None)`` as separate [B, H, W, S, C]
    tensors.  With ``use_fused_kernel`` the fused SIREN field runs (the
    kernel on a CUDA tensor, its plain version on a CPU one), from
    ``field_pack`` or from weights packed for this call.  Otherwise the
    field module (SIREN, NGP or FC) runs, under ``checkpoint`` when
    ``remat`` is on and autograd is recording.  The NGP field encodes
    through the hash-grid kernels on a CUDA tensor (the packed table where
    there is one), or through their plain versions on a CPU tensor or
    inside ``plain_encode``.
    """
    b, h, w, s, _ = pts.shape
    flat_pts = pts.reshape(b, h * w * s, 3).float().contiguous()
    flat_views = views.reshape(b, h * w * s, 3).float().contiguous()
    net = renderer.network
    if cfg.use_fused_kernel and cfg.type == "sdf" and cfg.output_features:
        pack = field_pack if field_pack is not None else pack_siren_field(net)
        gamma, beta = film_coeffs(net, style)
        rgb, sdf, feat = siren_field_fused_parts(pack, flat_pts, flat_views, gamma, beta)
    elif cfg.remat and torch.is_grad_enabled():
        # The network's tensors go in as inputs, so the recomputation sees
        # the ones of the forward even under a caller's parameter cast.
        names, tensors = zip(*chain(net.named_parameters(), net.named_buffers()))

        def run(p, v, s, *ts):
            return call_with(net, dict(zip(names, ts)), type(net).forward_parts, p, v, s)

        rgb, sdf, feat = checkpoint(run, flat_pts, flat_views, style, *tensors,
                                    use_reentrant=False)
    else:
        rgb, sdf, feat = net.forward_parts(flat_pts, flat_views, style)
    return (
        rgb.reshape(b, h, w, s, -1),
        sdf.reshape(b, h, w, s, 1),
        feat.reshape(b, h, w, s, -1) if feat is not None else None,
    )


def _sample_z_vals(
    cfg: RendererConfig,
    near: torch.Tensor,
    far: torch.Tensor,
    batch: int,
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """Depth samples [B, H, W, S]; near/far are [B, 1, 1, 1].  Without a
    generator (or with ``perturb <= 0``) the samples are deterministic."""
    res, s = cfg.out_im_res, cfg.n_samples
    t_vals = base_t_vals(s, cfg.offset_sampling, device=near.device).reshape(1, 1, 1, s)
    z_vals = near * (1.0 - t_vals) + far * t_vals
    z_vals = z_vals.expand(batch, res, res, s)
    if cfg.perturb <= 0.0 or generator is None:
        return z_vals
    if cfg.offset_sampling:
        upper = torch.cat([z_vals[..., 1:], far.expand(z_vals[..., :1].shape)], -1)
        lower = z_vals
        t_rand = torch.rand((batch, res, res), generator=generator,
                            device=near.device)[..., None]
    else:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        t_rand = torch.rand(z_vals.shape, generator=generator, device=near.device)
    return lower + (upper - lower) * t_rand


def _composite_features(weights: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
    """sum_s weights[..., s] * features[..., s, :] in f32, as a batched
    matmul over the sample axis.  The features keep their dtype and are
    widened (exactly) one batch element at a time, so a bf16 field never
    materializes an f32 copy of the whole [B, H, W, S, F] tensor."""
    b, h, w, s = weights.shape
    out = torch.empty(b, h, w, features.shape[-1], dtype=torch.float32,
                      device=weights.device)
    for i in range(b):
        wi = weights[i].reshape(h * w, 1, s)
        fi = features[i].reshape(h * w, s, -1).float()
        out[i] = torch.bmm(wi, fi).reshape(h, w, -1)
    return out


def _integrate(
    renderer: VolumeFeatureRenderer,
    cfg: RendererConfig,
    parts: Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]],
    z_vals: torch.Tensor,
    rays_d: torch.Tensor,
    pts: torch.Tensor,
    generator: Optional[torch.Generator] = None,
):
    """Alpha compositing in f32.  Returns (rgb, features, sdf, mask, xyz,
    weights); the optional ones are None unless the config asks for them."""
    rgb, sdf, features = parts
    z_vals = z_vals.float()
    dists = z_vals[..., 1:] - z_vals[..., :-1]  # [B,H,W,S-1]
    rays_d_norm = torch.linalg.norm(rays_d.float(), dim=-1)  # [B,H,W]
    if cfg.bg_mode == "lastsample":
        last = torch.full_like(rays_d_norm, 1e10)[..., None]
    else:
        last = dists[..., -1:]
    dists = torch.cat([dists, last], -1) * rays_d_norm[..., None]  # [B,H,W,S]

    rgb = rgb.float()
    sdf = sdf.float()
    sdf_s = sdf[..., 0]
    if cfg.with_sdf:
        beta = renderer.sigmoid_beta.float()
        sigma = torch.sigmoid(-sdf_s / beta) / beta
        alpha = 1.0 - torch.exp(-sigma * dists)
    else:
        noise = 0.0
        if cfg.raw_noise_std > 0.0 and generator is not None:
            noise = cfg.raw_noise_std * torch.randn(
                sdf_s.shape, generator=generator, device=sdf_s.device)
        alpha = 1.0 - torch.exp(-F.softplus(sdf_s + noise) * dists)

    trans = torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1)
    visibility = torch.cumprod(trans, -1)[..., :-1]
    weights = alpha * visibility  # [B,H,W,S]
    if cfg.force_background and cfg.bg_mode == "lastsample":
        last = 1.0 - torch.sum(weights[..., :-1], -1, keepdim=True)
        weights = torch.cat([weights[..., :-1], last], -1)

    w_exp = weights[..., None]
    rgb_map = -1.0 + 2.0 * torch.sum(w_exp * torch.sigmoid(rgb), -2)
    leftover = None
    if cfg.bg_mode != "lastsample":
        leftover = 1.0 - torch.sum(weights, -1, keepdim=True)  # [B,H,W,1]
        rgb_map = rgb_map + 2.0 * _BG_LEVEL[cfg.bg_mode] * leftover
    feature_map = (_composite_features(weights, features)
                   if cfg.output_features else None)
    xyz = mask = None
    if cfg.return_xyz:
        xyz = torch.sum(w_exp * pts, -2)
        mask = leftover if leftover is not None else weights[..., -1:]
    sdf_out = sdf if cfg.return_sdf else None
    weights_out = weights if cfg.return_weights else None
    return rgb_map, feature_map, sdf_out, mask, xyz, weights_out


def frustum_points(
    res: int,
    focal: torch.Tensor,
    c2w: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    u_uv: torch.Tensor,
    u_t: torch.Tensor,
) -> torch.Tensor:
    """World points [B, M, 3] on the rays of continuous pixels ``u_uv * res``
    ([B, M, 2]) at depths ``near + (far - near) * u_t`` ([B, M]), the
    uniform draws in [0, 1); near/far broadcast to [B, ...]."""
    batch, m = u_t.shape
    uv = u_uv * res
    focal2 = focal.reshape(batch, 1)
    dirs = torch.stack([(uv[..., 0] - res * 0.5) / focal2,
                        -(uv[..., 1] - res * 0.5) / focal2,
                        -torch.ones((batch, m), dtype=u_t.dtype, device=u_t.device)], dim=-1)
    rays_d = torch.einsum("bmi,bji->bmj", dirs, c2w[:, :3, :3])
    t = near.reshape(batch, 1) + (far - near).reshape(batch, 1) * u_t
    return c2w[:, None, :3, -1] + rays_d * t[..., None]


def _subsampled_eikonal(
    renderer: VolumeFeatureRenderer,
    cfg: RendererConfig,
    focal: torch.Tensor,
    c2w: torch.Tensor,
    near_b: torch.Tensor,
    far_b: torch.Tensor,
    style: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """d sdf / d pts [B, M, 3] at M = ``eikonal_subsample`` fresh frustum
    points per batch element: a random continuous pixel's ray at a random
    depth in [near, far], through the live camera.  ``draws`` = (uv [B, M, 2],
    t [B, M]) uniform in [0, 1) fixes the points; otherwise they come from
    ``generator``.  View directions are zeros (the SDF head never reads
    them).  The gradient is taken with respect to WORLD points, the
    z-normalization inside, as for the full eikonal term."""
    m, batch = cfg.eikonal_subsample, c2w.shape[0]
    if draws is None:
        draws = (torch.rand((batch, m, 2), generator=generator, device=c2w.device),
                 torch.rand((batch, m), generator=generator, device=c2w.device))
    pts_e = frustum_points(cfg.out_im_res, focal, c2w, near_b, far_b, *draws)
    scale = (2.0 / (far_b - near_b)).reshape(batch, 1, 1)
    views0 = torch.zeros_like(pts_e)[:, None, None]
    with torch.enable_grad():
        p = pts_e.detach().requires_grad_(True)
        normalized = p * scale if cfg.z_normalize else p
        _, sdf, _ = _apply_network(renderer, cfg, normalized[:, None, None], views0, style)
        (grad,) = torch.autograd.grad(sdf, p, torch.ones_like(sdf), create_graph=True)
    return grad


def render(
    renderer: VolumeFeatureRenderer,
    cfg: RendererConfig,
    focal: torch.Tensor,
    c2w: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    style: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    field_pack: Optional[SirenFieldPack] = None,
    return_eikonal: bool = False,
    eikonal_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> RenderOutput:
    """Full render pass.

    focal/near/far [B, 1, 1]; c2w [B, 3, 4]; style [B, style_dim].
    ``generator`` draws the depth jitter and, under ``eikonal_subsample``,
    the eikonal points (None: deterministic depths; the eikonal points then
    need ``eikonal_draws``, see :func:`_subsampled_eikonal`).
    ``return_eikonal`` adds ``eikonal_term`` = d sdf / d world points.
    """
    batch = c2w.shape[0]
    rays = get_rays(focal, c2w, cfg.out_im_res, static_viewdirs=cfg.static_viewdirs)
    viewdirs = rays.viewdirs
    near_b = near.reshape(batch, 1, 1, 1)
    far_b = far.reshape(batch, 1, 1, 1)
    z_vals = _sample_z_vals(cfg, near_b, far_b, batch, generator)
    pts = rays.origins[..., None, :] + rays.directions[..., None, :] * z_vals[..., None]
    if cfg.view_independent:
        viewdirs = torch.zeros_like(viewdirs)
    views = viewdirs[..., None, :].expand(pts.shape)

    def field(p):
        normalized = p * 2.0 / (far_b - near_b)[..., None] if cfg.z_normalize else p
        return _apply_network(renderer, cfg, normalized, views, style, field_pack)

    eikonal_term = None
    if return_eikonal and cfg.eikonal_subsample > 0:
        # A missing draw must not fall back to the full-graph eikonal term:
        # the configurations that subsample also turn remat off.
        if generator is None and eikonal_draws is None:
            raise ValueError("eikonal_subsample > 0 needs a generator or eikonal_draws "
                             "for the frustum points")
        parts = field(pts)
        eikonal_term = _subsampled_eikonal(renderer, cfg, focal, c2w, near_b, far_b, style,
                                           generator, eikonal_draws)
    elif return_eikonal and cfg.eikonal_mode != "vjp":
        raise NotImplementedError(
            f"eikonal_mode {cfg.eikonal_mode!r} is not ported: 'jvp' was a measured "
            "negative in the JAX package (ROADMAP.md, queue 1 item 5); use 'vjp'")
    elif return_eikonal:
        with torch.enable_grad():
            pts = pts.detach().requires_grad_(True)
            parts = field(pts)
            sdf = parts[1]
            (eikonal_term,) = torch.autograd.grad(sdf, pts, torch.ones_like(sdf),
                                                  create_graph=True)
    else:
        parts = field(pts)
    rgb_map, feature_map, sdf_out, mask, xyz, weights = _integrate(
        renderer, cfg, parts, z_vals, rays.directions, pts, generator
    )
    s_vals = None
    if cfg.return_weights:
        s_vals = ((z_vals - near_b) / (far_b - near_b)).float()
    return RenderOutput(rgb_map, feature_map, sdf_out, mask, xyz, eikonal_term, weights,
                        s_vals)


def mlp_init_pass(
    renderer: VolumeFeatureRenderer,
    cfg: RendererConfig,
    focal: torch.Tensor,
    c2w: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    style: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    t_rand: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sphere-init regression pass: ``(sdf [B, H, W, S], target)`` with
    ``target = ||pts|| - (far - near) / 4`` at stratified depth samples (the
    mid-point strata always).  ``t_rand`` [B, H, W, S] uniform in [0, 1)
    fixes the jitter; otherwise it comes from ``generator``."""
    batch = c2w.shape[0]
    res, s = cfg.out_im_res, cfg.n_samples
    rays = get_rays(focal, c2w, res, static_viewdirs=cfg.static_viewdirs)
    near_b = near.reshape(batch, 1, 1, 1)
    far_b = far.reshape(batch, 1, 1, 1)
    t_vals = base_t_vals(s, cfg.offset_sampling, device=near.device).reshape(1, 1, 1, s)
    z_vals = (near_b * (1.0 - t_vals) + far_b * t_vals).expand(batch, res, res, s)
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], -1)
    lower = torch.cat([z_vals[..., :1], mids], -1)
    if t_rand is None:
        if generator is None:
            raise ValueError("mlp_init_pass needs a generator or t_rand for the jitter")
        t_rand = torch.rand(z_vals.shape, generator=generator, device=near.device)
    z_vals = lower + (upper - lower) * t_rand
    pts = rays.origins[..., None, :] + rays.directions[..., None, :] * z_vals[..., None]
    views = rays.viewdirs[..., None, :].expand(pts.shape)
    normalized = pts * 2.0 / (far_b - near_b)[..., None] if cfg.z_normalize else pts
    _, sdf, _ = _apply_network(renderer, cfg, normalized, views, style)
    target = torch.linalg.norm(pts.detach(), dim=-1) - (far_b - near_b) / 4.0
    return sdf[..., 0], target
