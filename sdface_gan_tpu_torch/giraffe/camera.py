"""GIRAFFE camera and pixel geometry, port of ``sdface_gan_tpu/giraffe/camera.py``.

Intrinsics for a [-1, 1] sensor, look-at poses on the view sphere (+z up),
pixel grids (x-major, y inverted), and the pixels / origin -> world
transforms of the volume renderer.  ``torch.linspace`` rounds otherwise
than ``jnp.linspace``: the pixel grid, the depth steps and the mesh grid
stay within 2.4e-7 (two f32 ulps of 1) of JAX's.  A sampler is a draw from an explicit
``torch.Generator`` (on the CPU, so a seed gives the same draws on every
device) followed by a deterministic map of the draws.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def get_camera_mat(fov: float = 49.13, device=None) -> torch.Tensor:
    """[1, 4, 4] K^-1 of a [-1, 1] sensor's intrinsics (the renderer's
    direction)."""
    focal = 1.0 / math.tan(0.5 * fov * math.pi / 180.0)
    return torch.linalg.inv(torch.diag(torch.tensor([focal, focal, 1.0, 1.0], device=device))[None])


def to_sphere(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(u, v) in [0, 1]^2 -> the unit sphere."""
    theta = 2.0 * math.pi * u
    phi = torch.arccos(1.0 - 2.0 * v)
    return torch.stack([torch.sin(phi) * torch.cos(theta), torch.sin(phi) * torch.sin(theta),
                        torch.cos(phi)], dim=-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-5)


def look_at(eye: torch.Tensor) -> torch.Tensor:
    """Rotations [B, 3, 3] whose columns are the (x, y, z) axes of cameras
    at ``eye`` looking at the origin, +z world up (each norm at least 1e-5)."""
    up = torch.tensor([0.0, 0.0, 1.0], device=eye.device).expand(eye.shape)
    z = _unit(eye)
    x = _unit(torch.linalg.cross(up, z, dim=-1))
    y = _unit(torch.linalg.cross(z, x, dim=-1))
    return torch.stack([x, y, z], dim=-1)


def _pose_from_loc(loc: torch.Tensor) -> torch.Tensor:
    rt = torch.eye(4, device=loc.device).repeat(loc.shape[0], 1, 1)
    rt[:, :3, :3] = look_at(loc)
    rt[:, :3, 3] = loc
    return rt


def _in_range(x: torch.Tensor, rng: Sequence[float]) -> torch.Tensor:
    return rng[0] + x * (rng[1] - rng[0])


def pose_from_uniforms(uniforms: torch.Tensor, range_u, range_v, range_radius) -> torch.Tensor:
    """Camera-to-world poses [B, 4, 4] of U(0, 1) draws ``[3, B]`` (u, v,
    radius), each mapped into its range."""
    u, v, r = uniforms
    loc = to_sphere(_in_range(u, range_u), _in_range(v, range_v))
    loc = loc * _in_range(r, range_radius)[:, None]
    return _pose_from_loc(loc)


def get_random_pose(generator: torch.Generator, range_u, range_v, range_radius,
                    batch_size: int = 32, device=None) -> torch.Tensor:
    """Poses sampled uniformly within the ranges on the view sphere."""
    draws = torch.rand((3, batch_size), generator=generator).to(device)
    return pose_from_uniforms(draws, range_u, range_v, range_radius)


def get_camera_pose(range_u, range_v, range_r, val_u=0.5, val_v=0.5, val_r=0.5,
                    batch_size: int = 32, device=None) -> torch.Tensor:
    """The pose at fractional (u, v, r) positions within the ranges."""
    u = range_u[0] + val_u * (range_u[1] - range_u[0])
    v = range_v[0] + val_v * (range_v[1] - range_v[0])
    r = range_r[0] + val_r * (range_r[1] - range_r[0])
    loc = to_sphere(torch.full((batch_size,), u, device=device),
                    torch.full((batch_size,), v, device=device)) * r
    return _pose_from_loc(loc)


def get_rotation_matrix(value: float, batch_size: int = 32, device=None) -> torch.Tensor:
    """Rotations [B, 3, 3] about z by ``value * 2 pi``."""
    a = value * 2.0 * math.pi
    r = torch.tensor([[math.cos(a), -math.sin(a), 0.0], [math.sin(a), math.cos(a), 0.0],
                      [0.0, 0.0, 1.0]], device=device)
    return r[None].repeat(batch_size, 1, 1)


def arange_pixels(resolution: int, batch_size: int = 1, device=None) -> torch.Tensor:
    """Pixel coordinates [B, N, 2] in [-1, 1], x-major, y inverted."""
    lin = torch.linspace(-1.0, 1.0, resolution, device=device)
    xs, ys = torch.meshgrid(lin, lin, indexing="ij")
    pix = torch.stack([xs.reshape(-1), -ys.reshape(-1)], dim=-1)
    return pix[None].repeat(batch_size, 1, 1)


def image_points_to_world(pixels: torch.Tensor, camera_mat: torch.Tensor,
                          world_mat: torch.Tensor) -> torch.Tensor:
    """Image-plane pixels at depth -1 lifted to world space [B, N, 3]."""
    b, n, _ = pixels.shape
    hom = torch.cat([pixels, pixels.new_full((b, n, 1), -1.0), pixels.new_ones((b, n, 1))], -1)
    m = world_mat @ camera_mat
    return torch.einsum("bij,bnj->bni", m, hom)[..., :3]


def origin_to_world(n_points: int, camera_mat: torch.Tensor,
                    world_mat: torch.Tensor) -> torch.Tensor:
    """The camera origin in world space, repeated ``n_points`` times."""
    p = torch.tensor([0.0, 0.0, 0.0, 1.0], device=camera_mat.device)
    out = torch.einsum("bij,j->bi", world_mat @ camera_mat, p)[:, :3]
    return out[:, None, :].repeat(1, n_points, 1)


def interpolate_sphere(z1: torch.Tensor, z2: torch.Tensor, t: float) -> torch.Tensor:
    """Slerp between latent codes."""
    p = torch.sum(z1 * z2, dim=-1, keepdim=True)
    p = p / torch.sqrt(torch.sum(z1 ** 2, dim=-1, keepdim=True))
    p = p / torch.sqrt(torch.sum(z2 ** 2, dim=-1, keepdim=True))
    omega = torch.arccos(torch.clamp(p, -1.0, 1.0))
    s1 = torch.sin((1 - t) * omega) / torch.sin(omega)
    s2 = torch.sin(t * omega) / torch.sin(omega)
    return s1 * z1 + s2 * z2

