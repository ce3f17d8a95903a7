"""Geometry regularizers, port of ``sdface_gan_tpu/losses/geometry_losses.py``:
eikonal and minimal surface, occupancy sparsity, ray distortion, sphere
init.  (The hash-grid smoothness loss comes with NGP training.)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


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
