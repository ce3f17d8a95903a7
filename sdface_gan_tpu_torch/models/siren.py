"""FiLM-SIREN point network, port of ``sdface_gan_tpu/models/siren.py``.

Only the SIREN backbone (``SirenGenerator``) is ported; NGP and FC come
with later slices.  Module and parameter names follow the reference
``g_ema`` state dict (``renderer.network.pts_linears.{i}.gamma.weight``,
``renderer.network.views_linears.weight`` ...), so a reference state dict
loads with ``load_state_dict``.

Every matmul casts its input to the weight dtype, as the JAX package's
``x.astype(p["w"].dtype) @ p["w"]`` does: a model cast to bf16 runs its
GEMMs in bf16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.transcendental import fast_sin
from .init import film_siren_weight, linear_params, uniform


class LinearLayer(nn.Module):
    """SIREN-family LinearLayer: ``std_init * (x W^T + b) + bias_init``."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        mode: str = "kaiming",
        std_init: float = 1.0,
        bias_init: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        w, b = linear_params(in_dim, out_dim, generator, mode=mode)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(b)
        self.std_init = std_init
        self.bias_init = bias_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.linear(x.to(self.weight.dtype), self.weight) + self.bias
        if self.std_init != 1.0:
            out = self.std_init * out
        if self.bias_init != 0.0:
            out = out + self.bias_init
        return out


class FiLMSiren(nn.Module):
    """``sin(gamma(style) * (x W^T + b) + beta(style))``.

    gamma head: std 15, bias-init 30; beta head: std 0.25, bias-init 0.
    """

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        style_dim: int,
        is_first: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.weight = nn.Parameter(film_siren_weight(in_dim, out_dim, is_first, generator))
        self.bias = nn.Parameter(uniform((out_dim,), math.sqrt(1.0 / in_dim), generator))
        self.gamma = LinearLayer(style_dim, out_dim, std_init=15.0, bias_init=30.0,
                                 generator=generator)
        self.beta = LinearLayer(style_dim, out_dim, std_init=0.25, generator=generator)

    def film(self, style: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-sample FiLM coefficients (gamma, beta), each [B, out]."""
        return self.gamma(style), self.beta(style)

    def activate(self, out: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        """FiLM modulation and sine on a precomputed linear output [B, P, out]."""
        gamma, beta = self.film(style)
        return fast_sin(gamma[:, None, :] * out + beta[:, None, :])

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        out = F.linear(x.to(self.weight.dtype), self.weight) + self.bias
        return self.activate(out, style)


@dataclass(frozen=True)
class SirenConfig:
    depth: int = 8
    width: int = 256
    style_dim: int = 256
    output_features: bool = True


class SirenGenerator(nn.Module):
    """The 8-layer, 256-wide FiLM-SIREN field (reference ``SirenGenerator``)."""

    def __init__(self, cfg: SirenConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        w, s = cfg.width, cfg.style_dim
        self.pts_linears = nn.ModuleList(
            [FiLMSiren(3, w, s, is_first=True, generator=generator)]
            + [FiLMSiren(w, w, s, generator=generator) for _ in range(1, cfg.depth)]
        )
        self.views_linears = FiLMSiren(w + 3, w, s, generator=generator)
        self.rgb_linear = LinearLayer(w, 3, mode="freq", generator=generator)
        self.sigma_linear = LinearLayer(w, 1, mode="freq", generator=generator)

    def forward_parts(
        self, pts: torch.Tensor, views: torch.Tensor, style: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """``(rgb [B,P,3], sdf [B,P,1], features [B,P,W] | None)`` from
        pts/views [B, P, 3] and style [B, style_dim]."""
        h = pts
        for layer in self.pts_linears:
            h = layer(h, style)
        sdf = self.sigma_linear(h)
        # views_linears consumes concat([h, views]); the GEMM is split along
        # its input dim so the [N, W+3] concat is never materialized.
        vw = self.views_linears.weight
        width = h.shape[-1]
        vout = (
            F.linear(h.to(vw.dtype), vw[:, :width])
            + F.linear(views.to(vw.dtype), vw[:, width:])
            + self.views_linears.bias
        )
        feat = self.views_linears.activate(vout, style)
        rgb = self.rgb_linear(feat)
        return rgb, sdf, (feat if self.cfg.output_features else None)

    def forward(
        self, pts: torch.Tensor, views: torch.Tensor, style: torch.Tensor
    ) -> torch.Tensor:
        """Concatenated [B, P, 3+1(+W)] = [rgb, sdf(, features)] contract."""
        rgb, sdf, feat = self.forward_parts(pts, views, style)
        parts = [rgb, sdf] + ([feat] if feat is not None else [])
        return torch.cat(parts, -1)
