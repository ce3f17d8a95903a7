"""Bounding-box transforms of compositional scenes, port of
``sdface_gan_tpu/giraffe/bbox.py``: per-object scale, translation and
rotation within the configured ranges, a bounded collision resampling,
the plane constraint.  No parameters: a sampler (draws from an explicit
``torch.Generator`` on the CPU, then :func:`transformations_from_draws`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from .camera import get_rotation_matrix

COLLISION_ROUNDS = 8  # the collision resampling's fixed number of rounds

Transforms = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class BBoxConfig:
    n_boxes: int = 1
    scale_range_min: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    scale_range_max: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    translation_range_min: Tuple[float, float, float] = (-0.75, -0.75, 0.0)
    translation_range_max: Tuple[float, float, float] = (0.75, 0.75, 0.0)
    z_level_plane: float = 0.0
    rotation_range: Tuple[float, float] = (0.0, 1.0)
    check_collision: bool = False
    collision_padding: float = 0.1
    fix_scale_ratio: bool = True
    object_on_plane: bool = False


class BoxDraws(NamedTuple):
    """The uniform draws of :func:`sample_transformations`: scale [B, n, 1 or
    3], translation [B, n, 3], one translation per resampling round
    [R, B, n, 3], rotation [B, n]; with a ``prior``, its row per sample [B]
    instead of the translations."""
    scale: torch.Tensor
    translation: Optional[torch.Tensor]
    resample: Optional[torch.Tensor]
    rotation: torch.Tensor
    prior_pick: Optional[torch.Tensor] = None


def _rot_z(angles: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(angles), torch.sin(angles)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, zeros], -1), torch.stack([s, c, zeros], -1),
                        torch.stack([zeros, zeros, ones], -1)], dim=-2)


def _pairwise_free(cfg: BBoxConfig, s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """True where no pair of boxes overlaps (separated along some axis)."""
    free = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    for i in range(cfg.n_boxes):
        for j in range(i + 1, cfg.n_boxes):
            d_t = torch.abs(t[:, i] - t[:, j])
            d_s = torch.abs(s[:, i] + s[:, j]) + cfg.collision_padding
            free = free & torch.any(d_t >= d_s, dim=-1)
    return free


def _ranges(cfg: BBoxConfig, device):
    smin = torch.tensor(cfg.scale_range_min, device=device)
    tmin = torch.tensor(cfg.translation_range_min, device=device)
    return (smin, torch.tensor(cfg.scale_range_max, device=device) - smin,
            tmin, torch.tensor(cfg.translation_range_max, device=device) - tmin)


def transformations_from_draws(cfg: BBoxConfig, draws: BoxDraws,
                               prior: Optional[torch.Tensor] = None) -> Transforms:
    """(s [B, n, 3], t [B, n, 3], R [B, n, 3, 3]) of the draws: each mapped
    into its range; a sample whose boxes collide takes the next round's
    translations, for as many rounds as were drawn."""
    smin, srange, tmin, trange = _ranges(cfg, draws.scale.device)
    s = smin + draws.scale * srange
    if prior is not None:
        t = prior[draws.prior_pick]
    else:
        t = tmin + draws.translation * trange
        for t_draw in draws.resample if draws.resample is not None else ():
            free = _pairwise_free(cfg, s, t)
            t = torch.where(free[:, None, None], t, tmin + t_draw * trange)
    if cfg.object_on_plane:
        t = t.clone()
        t[..., -1] = cfg.z_level_plane
    r0, r1 = cfg.rotation_range
    rv = r0 + draws.rotation * (r1 - r0)
    return s, t, _rot_z(rv * 2.0 * math.pi)


def sample_transformations(generator: torch.Generator, cfg: BBoxConfig, batch_size: int,
                           prior: Optional[torch.Tensor] = None,
                           device=None) -> Transforms:
    """Random box transforms.  ``prior`` ([M, n_boxes, 3], e.g. the CLEVR
    location prior) replaces the uniform translations; collisions are
    resampled ``COLLISION_ROUNDS`` times (a fixed count, as the JAX
    package's static unroll) when the config checks them."""
    n = cfg.n_boxes

    def rand(*shape):
        return torch.rand(shape, generator=generator).to(device)

    scale = rand(batch_size, n, 1 if cfg.fix_scale_ratio else 3)
    translation = resample = pick = None
    if prior is not None:
        pick = torch.randint(prior.shape[0], (batch_size,), generator=generator).to(device)
    else:
        translation = rand(batch_size, n, 3)
        if cfg.check_collision:
            resample = rand(COLLISION_ROUNDS, batch_size, n, 3)
    draws = BoxDraws(scale, translation, resample, rand(batch_size, n), pick)
    return transformations_from_draws(cfg, draws, prior)


def fixed_transformations(cfg: BBoxConfig, batch_size: int,
                          val_s: Sequence[Sequence[float]] = ((0.5, 0.5, 0.5),),
                          val_t: Sequence[Sequence[float]] = ((0.5, 0.5, 0.5),),
                          val_r: Sequence[float] = (0.5,), device=None) -> Transforms:
    """Transforms at fractional positions within the ranges."""
    smin, srange, tmin, trange = _ranges(cfg, device)
    vs = torch.tensor(val_s, dtype=torch.float32, device=device)[None]
    vt = torch.tensor(val_t, dtype=torch.float32, device=device)[None]
    s = smin + (vs[..., :1] if cfg.fix_scale_ratio else vs) * srange
    t = tmin + vt * trange
    if cfg.object_on_plane:
        t[..., -1] = cfg.z_level_plane
    r0, r1 = cfg.rotation_range
    rs = torch.stack([get_rotation_matrix(float(r0 + v * (r1 - r0)), 1, device=device)[0]
                      for v in val_r])[None]
    return (s.repeat(batch_size, 1, 1), t.repeat(batch_size, 1, 1),
            rs.repeat(batch_size, 1, 1, 1))


def transform_points_to_box(p: torch.Tensor, s: torch.Tensor, t: torch.Tensor,
                            r: torch.Tensor, box_idx: int = 0) -> torch.Tensor:
    """World -> box-local coordinates ``R (p - t) / s`` of [B, N, 3] points."""
    shifted = p - t[:, box_idx][:, None, :]
    local = torch.einsum("bij,bnj->bni", r[:, box_idx], shifted)
    return local / s[:, box_idx][:, None, :]
