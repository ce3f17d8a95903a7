"""Ray sharding, port of ``sdface_gan_tpu/parallel/rays.py``.

A test-mode render is embarrassingly parallel over its rays (the cumprod
over samples stays within a ray), so a large single-image render, such as
the 128^2 x 128-sample surface probe, splits its image rows over the ranks:
rank r renders the band ``[r H / W, (r + 1) H / W)`` through the renderer's
own network and compositing, and the bands are gathered.  JAX's
``shard_map`` needs no collective until the output is read; here the gather
is explicit and every rank returns the whole render.
"""

from __future__ import annotations

from typing import Optional

import torch

from .mesh import Mesh, gather_rows


def _band(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x[:, mesh.rows(x.shape[1], "image height")]


def render_ray_sharded(renderer, cfg, focal: torch.Tensor, c2w: torch.Tensor,
                       near: torch.Tensor, far: torch.Tensor, style: torch.Tensor,
                       mesh: Optional[Mesh], field_pack=None):
    """The deterministic (test-mode) :func:`~sdface_gan_tpu_torch.models.renderer.render`
    with the image rows split over ``mesh`` (the world must divide the image
    height).  Without a group it is ``render`` itself."""
    from ..geometry.rays import get_rays
    from ..models.renderer import RenderOutput, _apply_network, _integrate, _sample_z_vals, render

    if mesh is None or not mesh.distributed:
        return render(renderer, cfg, focal, c2w, near, far, style, field_pack=field_pack)
    res = cfg.out_im_res
    if res % mesh.world:
        raise ValueError(f"image height {res} must divide the {mesh.world}-rank world")
    batch = c2w.shape[0]
    rays = get_rays(focal, c2w, res, static_viewdirs=cfg.static_viewdirs)
    viewdirs = torch.zeros_like(rays.viewdirs) if cfg.view_independent else rays.viewdirs
    near_b = near.reshape(batch, 1, 1, 1)
    far_b = far.reshape(batch, 1, 1, 1)
    z_vals = _band(_sample_z_vals(cfg, near_b, far_b, batch, None), mesh)
    origins, dirs, views = (_band(t, mesh) for t in (rays.origins, rays.directions, viewdirs))
    pts = origins[..., None, :] + dirs[..., None, :] * z_vals[..., None]
    normalized = pts * 2.0 / (far_b - near_b)[..., None] if cfg.z_normalize else pts
    parts = _apply_network(renderer, cfg, normalized, views[..., None, :].expand(pts.shape),
                           style, field_pack)
    out = _integrate(renderer, cfg, parts, z_vals, dirs, pts)
    rgb, features, sdf, mask, xyz, weights = (
        None if t is None else gather_rows(t, mesh, dim=1) for t in out)
    return RenderOutput(rgb, features, sdf, mask, xyz, None, weights, None)


def place_ray_sharded(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's band of rows of an image-shaped [B, H, ...] tensor."""
    if mesh is None or not mesh.distributed:
        return x
    return _band(x, mesh)
