"""Geometry regularizers, port of ``sdface_gan_tpu/losses/geometry_losses.py``:
eikonal and minimal surface, occupancy sparsity, ray distortion, sphere
init, and the hash-grid smoothness of the NGP field.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..ops.hash_encoder import HashGridSpec, hash_encode


def eikonal_loss(
    eikonal_term: Optional[torch.Tensor],
    sdf: Optional[torch.Tensor] = None,
    beta: float = 100.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mean((||grad sdf|| - 1)^2)`` and the minimal-surface term
    ``mean(exp(-beta |sdf|))``; a missing input gives a zero."""
    ref = eikonal_term if eikonal_term is not None else sdf
    zero = torch.zeros((), device=ref.device if ref is not None else None)
    eik = zero if eikonal_term is None else torch.mean(
        (torch.linalg.norm(eikonal_term, dim=-1) - 1.0) ** 2)
    min_surf = zero if sdf is None else torch.mean(torch.exp(-beta * torch.abs(sdf)))
    return eik, min_surf


def occupancy_sparsity_loss(sdf: torch.Tensor, sigmoid_beta: torch.Tensor) -> torch.Tensor:
    """Mean occupancy ``sigmoid(-sdf / beta)`` over the ray samples, with
    ``beta`` detached (the prior must not widen the sigmoid instead of
    clearing space)."""
    beta = sigmoid_beta.detach().float()
    return torch.mean(torch.sigmoid(-sdf.float() / beta))


def distortion_loss(weights: torch.Tensor, s_vals: torch.Tensor) -> torch.Tensor:
    """mip-NeRF 360 distortion over [B, H, W, S] weights and ascending
    normalized samples, in the exact O(S) cumulative-sum form."""
    w = weights.float()
    s = s_vals.float()
    d = torch.diff(s, dim=-1)
    d = torch.cat([d, d[..., -1:]], dim=-1)
    ws = w * s
    w_before = torch.cumsum(w, dim=-1) - w
    ws_before = torch.cumsum(ws, dim=-1) - ws
    pairwise = 2.0 * torch.sum(w * (s * w_before - ws_before), dim=-1)
    intra = torch.sum(w * w * d, dim=-1) / 3.0
    return torch.mean(pairwise + intra)


def sphere_init_loss(sdf: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 regression of the raw SDF to a centered sphere."""
    return torch.mean(torch.abs(sdf - target))


def hash_smoothness_loss(
    table: torch.Tensor,
    spec: HashGridSpec,
    bbox: Sequence[Sequence[float]],
    sample_points: int = 32,
    voxel_size: float = 0.1,
    margin: float = 0.05,
    bound: float = 2.0,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Total-variation smoothness of the hash embedding on a randomly placed
    axis-aligned grid (reference ``smoothLoss.py:5-29``): a
    ``(sample_points - 1)^3`` integer grid, jittered by one sub-voxel
    offset, scaled by ``voxel_size``, placed at a random offset inside
    ``bbox`` (``[3, 2]`` min/max per axis), normalized to [0, 1] per axis
    and encoded (the encode maps through ``(x + bound) / (2 bound)``); the
    summed squared difference of grid-neighbour embeddings along each axis,
    divided by ``sample_points**3``.

    ``draws`` = (offset [3], jitter [3]) uniform in [0, 1) fixes the two
    draws; otherwise they come from ``generator``."""
    device = table.device
    n = sample_points - 1
    box = torch.as_tensor(bbox, dtype=torch.float32, device=device)
    lo, hi = box[:, 0], box[:, 1]
    if draws is None:
        if generator is None:
            raise ValueError("hash_smoothness_loss needs a generator or draws")
        draws = (torch.rand(3, generator=generator, device=device),
                 torch.rand(3, generator=generator, device=device))
    u_offset, jitter = (torch.as_tensor(d, dtype=torch.float32, device=device).reshape(3)
                        for d in draws)
    offset = u_offset * (hi - lo - n * voxel_size - 2.0 * margin) + margin
    idx = torch.arange(n, dtype=torch.float32, device=device)
    coords = torch.stack(torch.meshgrid(idx, idx, idx, indexing="ij"), -1)  # [n, n, n, 3]
    pts = (coords + jitter) * voxel_size + lo + offset
    emb = hash_encode(((pts - lo) / (hi - lo)).contiguous(), table, spec, bound=bound)
    tv = (torch.sum((emb[1:] - emb[:-1]) ** 2) + torch.sum((emb[:, 1:] - emb[:, :-1]) ** 2)
          + torch.sum((emb[:, :, 1:] - emb[:, :, :-1]) ** 2))
    return tv / float(sample_points**3)
