"""The field networks, port of ``sdface_gan_tpu/models/siren.py``.

* ``SirenGenerator``    - the 8-layer FiLM-SIREN field;
* ``NGPSIRENGenerator`` - hash-grid encode + SH view encode + a short
  FiLM-SIREN stack;
* ``FCGenerator``       - the plain ReLU MLP with NeRF positional encoding.

Module and parameter names follow the reference ``g_ema`` state dict
(``renderer.network.pts_linears.{i}.gamma.weight``,
``renderer.network.encoder.embeddings`` ...), so a reference state dict
loads with ``load_state_dict``.  Each network's ``forward_parts`` returns
``(rgb, sdf, features | None)`` as separate tensors.

Every matmul casts its input to the weight dtype, as the JAX package's
``x.astype(p["w"].dtype) @ p["w"]`` does: a model cast to bf16 runs its
GEMMs in bf16.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.hash_encoder import (
    HashGridSpec,
    PackPlan,
    hash_encode,
    hash_encode_packed,
    hash_encode_reference,
    pack_hash_table,
    plan_packing,
)
from ..ops.sh_encoder import sh_encode, sh_output_dim
from ..ops.transcendental import fast_sin_lean
from .init import film_siren_weight, hash_table, linear_params, uniform


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


def _split_views_linear(layer, h: torch.Tensor, views: torch.Tensor) -> torch.Tensor:
    """``layer``'s linear part on concat([h, views]), as two GEMMs over the
    split weight so the [N, W + V] concat is never materialized."""
    w = layer.weight
    width = h.shape[-1]
    return (F.linear(h.to(w.dtype), w[:, :width]) + F.linear(views.to(w.dtype), w[:, width:])
            + layer.bias)


def _concat_parts(rgb, sdf, feat) -> torch.Tensor:
    return torch.cat([rgb, sdf] + ([feat] if feat is not None else []), -1)


class FiLMSiren(nn.Module):
    """``sin(gamma(style) * (x W^T + b) + beta(style))``.

    gamma head: std 15, bias-init 30; beta head: std 0.25, bias-init 0.
    The sine is ``fast_sin_lean``: in training its autograd saves only its
    argument (the eikonal term's double backward runs through it).
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
        return fast_sin_lean(gamma[:, None, :] * out + beta[:, None, :])

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
        feat = self.views_linears.activate(_split_views_linear(self.views_linears, h, views),
                                           style)
        rgb = self.rgb_linear(feat)
        return rgb, sdf, (feat if self.cfg.output_features else None)

    def forward(
        self, pts: torch.Tensor, views: torch.Tensor, style: torch.Tensor
    ) -> torch.Tensor:
        """Concatenated [B, P, 3+1(+W)] = [rgb, sdf(, features)] contract."""
        return _concat_parts(*self.forward_parts(pts, views, style))


# ---------------------------------------------------------------------------
# NGPSIRENGenerator - hash-grid backbone
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NGPSirenConfig:
    depth: int = 2  # reference D=2 -> 1 + D = 3 FiLM-SIREN layers
    width: int = 256
    style_dim: int = 256
    bound: float = 2.0
    sh_degree: int = 4
    output_features: bool = True
    grid: HashGridSpec = HashGridSpec.create(desired_resolution=4096)
    # Corner-packed inference tables (ops/hash_encoder.py PackPlan): the
    # levels whose packed bf16 form fits this many MB are packed; 0 = off.
    pack_mb: int = 0

    @property
    def pack_plan(self) -> Optional[PackPlan]:
        if self.pack_mb <= 0:
            return None
        return plan_packing(self.grid, max_bytes=self.pack_mb << 20, bytes_per_el=2)


class HashGridEncoder(nn.Module):
    """The hash table (``embeddings`` [table_size, level_dim]) and, once
    :meth:`pack` has run, its corner-packed inference copy ``packed``: a
    non-persistent buffer, so state dicts carry the standard table only."""

    def __init__(self, spec: HashGridSpec, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embeddings = nn.Parameter(hash_table(spec.table_size, spec.level_dim, generator))
        self.register_buffer("packed", None, persistent=False)

    @torch.no_grad()
    def pack(self, plan: PackPlan) -> None:
        """Build the packed table once, in the table's dtype and device."""
        self.packed = pack_hash_table(self.embeddings, plan, dtype=self.embeddings.dtype)


_PLAIN_ENCODE = contextvars.ContextVar("plain_encode", default=False)


@contextlib.contextmanager
def plain_encode():
    """Within this block the NGP field encodes through the plain versions
    of the hash-grid kernels whatever the device: the kernels' yardstick,
    which ``SDFaceSampler(use_fused_kernel=False)`` serves.  For inference:
    a field that ``remat`` recomputes in a backward pass run after the
    block would encode through the kernels there."""
    token = _PLAIN_ENCODE.set(True)
    try:
        yield
    finally:
        _PLAIN_ENCODE.reset(token)


class NGPSIRENGenerator(nn.Module):
    """Hash-grid encode, SH-encoded view directions, ``depth + 1`` FiLM-SIREN
    layers of width W, sdf and rgb heads (reference ``NGPSIRENGenerator``)."""

    def __init__(self, cfg: NGPSirenConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        w, s = cfg.width, cfg.style_dim
        self.encoder = HashGridEncoder(cfg.grid, generator=generator)
        self.input_linear = LinearLayer(cfg.grid.output_dim, w, mode="freq",
                                        generator=generator)
        self.pts_linears = nn.ModuleList(
            [FiLMSiren(w, w, s, is_first=True, generator=generator)]
            + [FiLMSiren(w, w, s, generator=generator) for _ in range(cfg.depth)]
        )
        self.views_linears = FiLMSiren(sh_output_dim(cfg.sh_degree) + w, w, s,
                                       generator=generator)
        self.rgb_linear = LinearLayer(w, 3, mode="freq", generator=generator)
        self.sigma_linear = LinearLayer(w, 1, mode="freq", generator=generator)

    def pack_tables(self) -> None:
        """Add the corner-packed inference table (no-op when ``pack_mb`` is 0
        or the table is packed already)."""
        plan = self.cfg.pack_plan
        if plan is not None and self.encoder.packed is None:
            self.encoder.pack(plan)

    def encode(self, pts: torch.Tensor) -> torch.Tensor:
        """Hash encoding of [B, P, 3] points, through the packed table when
        there is one (inference).  By the tensor's device: the CUDA kernels
        on a CUDA tensor (with autograd, the differentiable encode), their
        plain versions on a CPU one; inside :func:`plain_encode` the plain
        versions whatever the device."""
        cfg, table = self.cfg, self.encoder.embeddings
        use_kernels = not _PLAIN_ENCODE.get()
        if cfg.pack_mb > 0 and self.encoder.packed is not None:
            return hash_encode_packed(pts, table, self.encoder.packed, cfg.pack_plan,
                                      bound=cfg.bound, use_kernels=use_kernels)
        encode = hash_encode if use_kernels else hash_encode_reference
        return encode(pts, table, cfg.grid, bound=cfg.bound)

    def forward_parts(
        self, pts: torch.Tensor, views: torch.Tensor, style: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """``(rgb [B,P,3], sdf [B,P,1], features [B,P,W] | None)``."""
        enc = self.encode(pts)
        dirs = sh_encode(views, degree=self.cfg.sh_degree)
        h = self.input_linear(enc.to(pts.dtype))
        for layer in self.pts_linears:
            h = layer(h, style)
        sdf = self.sigma_linear(h)
        feat = self.views_linears.activate(_split_views_linear(self.views_linears, h, dirs),
                                           style)
        rgb = self.rgb_linear(feat)
        return rgb, sdf, (feat if self.cfg.output_features else None)

    def forward(self, pts, views, style) -> torch.Tensor:
        """Concatenated [rgb, sdf(, features)] channel contract."""
        return _concat_parts(*self.forward_parts(pts, views, style))


# ---------------------------------------------------------------------------
# FCGenerator - classic NeRF MLP ablation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FCConfig:
    depth: int = 8
    width: int = 256
    style_dim: int = 256
    n_freq: int = 10
    n_freq_views: int = 4
    output_features: bool = True


def positional_encoding(p: torch.Tensor, n_freq: int) -> torch.Tensor:
    """NeRF PE with the reference's /2 pre-scale and [sin_xyz, cos_xyz] per
    frequency layout."""
    p = p / 2.0
    feats = []
    for i in range(n_freq):
        arg = (2.0**i) * math.pi * p
        feats.append(torch.cat([torch.sin(arg), torch.cos(arg)], -1))
    return torch.cat(feats, -1)


class FCGenerator(nn.Module):
    """ReLU MLP; style enters additively after the first layer (reference
    ``FCGenerator``).  Every linear layer has torch ``nn.Linear``'s init."""

    def __init__(self, cfg: FCConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        w = cfg.width

        def linear(i, o):
            return LinearLayer(i, o, mode="torch", generator=generator)

        self.x_in = linear(3 * cfg.n_freq * 2, w)
        self.style_in = linear(cfg.style_dim, w)
        self.pts_linears = nn.ModuleList([linear(w, w) for _ in range(cfg.depth - 1)])
        self.views_linears = linear(3 * cfg.n_freq_views * 2 + w, w)
        self.rgb_linear = linear(w, 3)
        self.sigma_linear = linear(w, 1)

    def forward_parts(
        self, pts: torch.Tensor, views: torch.Tensor, style: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        x = positional_encoding(pts, self.cfg.n_freq)
        v = positional_encoding(views, self.cfg.n_freq_views)
        h = torch.relu(self.x_in(x) + self.style_in(style)[:, None, :])
        for layer in self.pts_linears:
            h = torch.relu(layer(h))
        sdf = self.sigma_linear(h)
        # the reference applies no activation after views_linears here
        feat = _split_views_linear(self.views_linears, h, v)
        rgb = self.rgb_linear(feat)
        return rgb, sdf, (feat if self.cfg.output_features else None)

    def forward(self, pts, views, style) -> torch.Tensor:
        """Concatenated [rgb, sdf(, features)] channel contract."""
        return _concat_parts(*self.forward_parts(pts, views, style))
