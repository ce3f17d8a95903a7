"""Ray generation, port of ``sdface_gan_tpu/geometry/rays.py``.

Pixel-centre meshgrid -> camera rays rotated into world space; layout is
channel-last ([B, H, W, 3]) as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class Rays(NamedTuple):
    origins: torch.Tensor  # [B, H, W, 3]
    directions: torch.Tensor  # [B, H, W, 3]
    viewdirs: torch.Tensor  # [B, H, W, 3] normalized


def pixel_grid(res: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel-centre coordinates (i varies along W, j along H), each [1, H, W]."""
    lin = torch.linspace(0.5, res - 0.5, res, device=device)
    jj, ii = torch.meshgrid(lin, lin, indexing="ij")
    return ii[None], jj[None]


def get_rays(
    focal: torch.Tensor, c2w: torch.Tensor, res: int, static_viewdirs: bool = False
) -> Rays:
    """Camera rays for focal [B, 1, 1] and camera-to-world c2w [B, 3, 4]."""
    ii, jj = pixel_grid(res, device=focal.device)
    dirs = torch.stack(
        [
            (ii - res * 0.5) / focal,
            -(jj - res * 0.5) / focal,
            -torch.ones_like(ii) * torch.ones_like(focal),
        ],
        dim=-1,
    )  # [B, H, W, 3]
    rays_d = torch.sum(dirs[..., None, :] * c2w[:, None, None, :3, :3], dim=-1)
    rays_o = c2w[:, None, None, :3, -1].expand(rays_d.shape)
    raw_view = dirs if static_viewdirs else rays_d
    viewdirs = raw_view / torch.linalg.norm(raw_view, dim=-1, keepdim=True)
    return Rays(rays_o, rays_d, viewdirs)


def base_t_vals(n_samples: int, offset_sampling: bool, device: torch.device) -> torch.Tensor:
    """Canonical per-ray sample positions in [0, 1]."""
    stop = 1.0 - 1.0 / n_samples if offset_sampling else 1.0
    return torch.linspace(0.0, stop, n_samples, device=device)
