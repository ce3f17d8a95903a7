"""Camera sampling, port of ``sdface_gan_tpu/geometry/cameras.py``.

Cameras sit on the unit sphere looking at the origin; azimuth/elevation are
Gaussian (std) or uniform (range), an 8-azimuth sweep, or given
(``locations``); intrinsics come from a half-angle fov (default 6 degrees)
with near/far = 1 -/+ dist_radius.  Randomness comes from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch

from ..utils.device import resolve_device


class CameraParams(NamedTuple):
    extrinsics: torch.Tensor  # [B, 3, 4] camera-to-world [R^T | t]
    focal: torch.Tensor  # [B, 1, 1]
    near: torch.Tensor  # [B, 1, 1]
    far: torch.Tensor  # [B, 1, 1]
    viewpoint: torch.Tensor  # [B, 2] (azim, elev)


def _normalize(v: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # torch F.normalize semantics: x / max(||x||, eps)
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=eps)


def camera_extrinsics_from_angles(
    azim: torch.Tensor, elev: torch.Tensor, dist: torch.Tensor
) -> torch.Tensor:
    """Look-at extrinsics [B, 3, 4] for cameras at (azim, elev, dist),
    with the degenerate-x-axis fix when the view direction is parallel to up."""
    azim, elev, dist = azim.reshape(-1), elev.reshape(-1), dist.reshape(-1)
    camera_dir = torch.stack(
        [torch.cos(elev) * torch.sin(azim), torch.sin(elev),
         torch.cos(elev) * torch.cos(azim)], dim=-1)  # [B, 3]
    camera_loc = dist[:, None] * camera_dir

    up = torch.tensor([0.0, 1.0, 0.0], device=azim.device).expand(camera_dir.shape)
    z_axis = _normalize(camera_dir)
    x_axis = _normalize(torch.linalg.cross(up, z_axis, dim=-1))
    y_axis = _normalize(torch.linalg.cross(z_axis, x_axis, dim=-1))
    is_close = torch.all(torch.abs(x_axis) < 5e-3, dim=-1, keepdim=True)
    replacement = _normalize(torch.linalg.cross(y_axis, z_axis, dim=-1))
    x_axis = torch.where(is_close, replacement, x_axis)

    r = torch.stack([x_axis, y_axis, z_axis], dim=1)  # [B, 3, 3] rows
    return torch.cat([r.transpose(1, 2), camera_loc[:, :, None]], dim=-1)


def generate_camera_params(
    resolution: int,
    generator: Optional[torch.Generator] = None,
    batch: int = 1,
    locations: Optional[torch.Tensor] = None,
    sweep: bool = False,
    uniform: bool = False,
    azim_range: float = 0.3,
    elev_range: float = 0.15,
    fov_ang: float = 6.0,
    dist_radius: float = 0.12,
    device: Union[str, torch.device] = "cuda",
) -> CameraParams:
    """Sample camera extrinsics and intrinsics on ``device``.

    ``locations`` ([B, 2] azim/elev) overrides sampling and sets the device;
    ``sweep`` renders 8 fixed azimuths per identity with one random
    elevation each (seed 0 without a generator).  Otherwise angles are
    N(0, range), or U(-range, range) when ``uniform``; these need a
    generator on ``device``.  ``device`` defaults to the card and raises
    without one; pass ``device="cpu"`` to sample on the CPU.
    """
    device = locations.device if locations is not None else resolve_device(device)
    if locations is not None:
        azim = locations[:, 0].reshape(-1, 1).float()
        elev = locations[:, 1].reshape(-1, 1).float()
    elif sweep:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        azim = -azim_range + (2 * azim_range / 7) * torch.arange(8.0, device=device)
        azim = azim.reshape(-1, 1).repeat(batch, 1)
        elev_rand = torch.rand((batch, 1), generator=generator, device=device)
        elev = -elev_range + 2 * elev_range * torch.repeat_interleave(elev_rand, 8, dim=0)
    else:
        if generator is None:
            raise ValueError("a generator is required for random camera sampling")
        if uniform:
            azim = -azim_range + 2 * azim_range * torch.rand(
                (batch, 1), generator=generator, device=device)
            elev = -elev_range + 2 * elev_range * torch.rand(
                (batch, 1), generator=generator, device=device)
        else:
            azim = azim_range * torch.randn((batch, 1), generator=generator, device=device)
            elev = elev_range * torch.randn((batch, 1), generator=generator, device=device)
    n = azim.shape[0]

    dist = torch.ones((n, 1), device=device)
    near = (dist - dist_radius)[:, :, None]
    far = (dist + dist_radius)[:, :, None]
    fov_rad = fov_ang * math.pi / 180.0
    focal = torch.full((n, 1, 1), 0.5 * resolution / math.tan(fov_rad), device=device)
    viewpoint = torch.cat([azim, elev], dim=1)
    extrinsics = camera_extrinsics_from_angles(azim, elev, dist)
    return CameraParams(extrinsics, focal, near, far, viewpoint)
