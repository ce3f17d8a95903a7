"""GIRAFFE NeRF decoders, port of ``sdface_gan_tpu/giraffe/decoder.py``.

* :class:`GiraffeDecoder` - the NeRF MLP with additive latent codes, skip
  connections, and a view-dependent feature head, over the NeRF
  positional (``normal``), Gaussian-Fourier (``gauss``) or hash-grid
  (``hash``, with SH-encoded view directions) encodings;
* :class:`SmallDecoder` - the NGP-style compact MLP of ``--small_net``.

The hash encodings go through ``ops.hash_encoder.hash_encode`` on
box-local points divided by ``hash_div`` with ``bound=1``: the
hand-written CUDA kernel on a CUDA tensor, the plain encode on a CPU one;
points outside [-1, 1]^3 encode to zeros.  Parameter names follow the JAX
tree (``fc_in``, ``blocks.{i}``, ``sigma_out``, ``hash_table``, ``B_pos``
...), so ``utils.convert.jax_giraffe_params_to_state_dict`` is a
permutation of layouts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.init import hash_table, linear_params, normal
from ..models.siren import positional_encoding
from ..ops.hash_encoder import HashGridSpec, hash_encode
from ..ops.sh_encoder import sh_encode, sh_output_dim

# The hash grid's box (``giraffe/config.py:64`` of the reference, where it
# is fixed), kept as the JAX package keeps it.
GIRAFFE_HASH_BBOX = np.array(
    [[-1.5373, 1.5373], [-1.3903, 1.3903], [-1.0001, 1.0001]], dtype=np.float32)


def giraffe_hash_spec(finest_res: int = 512, log2_hashmap_size: int = 19) -> HashGridSpec:
    """The ``--i_embed`` / ``--small_net`` grid: 16 levels of 2 features from 16
    to ``finest_res``, tables of at most ``2 ** log2_hashmap_size`` rows."""
    return HashGridSpec.create(num_levels=16, level_dim=2, base_resolution=16,
                               log2_hashmap_size=log2_hashmap_size,
                               desired_resolution=finest_res)


@dataclass(frozen=True)
class DecoderConfig:
    hidden_size: int = 128
    n_blocks: int = 8
    n_blocks_view: int = 1
    skips: Tuple[int, ...] = (4,)
    use_viewdirs: bool = True
    n_freq_posenc: int = 10
    n_freq_posenc_views: int = 4
    z_dim: int = 64
    rgb_out_dim: int = 128
    final_sigmoid_activation: bool = False
    downscale_p_by: float = 2.0
    positional_encoding: str = "normal"  # 'normal' | 'gauss' | 'hash'
    gauss_dim_pos: int = 10
    gauss_dim_view: int = 4
    gauss_std: float = 4.0
    hash_spec: Optional[HashGridSpec] = None  # the 'hash' encoding's grid
    sh_degree: int = 4
    hash_div: float = 15.0

    def __post_init__(self):
        if self.positional_encoding == "hash" and self.hash_spec is None:
            raise ValueError("the 'hash' encoding needs its hash_spec (giraffe_hash_spec)")

    @property
    def dim_embed(self) -> int:
        if self.positional_encoding == "gauss":
            return 3 * self.gauss_dim_pos * 2
        if self.positional_encoding == "hash":
            return self.hash_spec.output_dim
        return 3 * self.n_freq_posenc * 2

    @property
    def dim_embed_view(self) -> int:
        if self.positional_encoding == "gauss":
            return 3 * self.gauss_dim_view * 2
        if self.positional_encoding == "hash":
            return sh_output_dim(self.sh_degree)
        return 3 * self.n_freq_posenc_views * 2

    @property
    def n_skips(self) -> int:
        return sum(1 for i in range(self.n_blocks - 1) if i in self.skips)


def torch_linear(in_dim: int, out_dim: int, generator: torch.Generator) -> nn.Linear:
    """``nn.Linear`` with torch's default distribution, U(+-1/sqrt(in)) for
    weight and bias, drawn from ``generator``."""
    layer = nn.Linear(in_dim, out_dim, device="meta")
    w, b = linear_params(in_dim, out_dim, generator, mode="torch")
    layer.weight, layer.bias = nn.Parameter(w), nn.Parameter(b)
    return layer


def _encode_hash(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec,
                 hash_div: float) -> torch.Tensor:
    return hash_encode(x / hash_div, table, spec, bound=1.0)


def _unit_rays(ray_d: torch.Tensor) -> torch.Tensor:
    return ray_d / torch.linalg.norm(ray_d, dim=-1, keepdim=True)


class GiraffeDecoder(nn.Module):
    """Points [B, N, 3], rays [B, N, 3] (or None), z_shape / z_app [B, z] ->
    (features [B, N, rgb_out_dim], sigma [B, N])."""

    def __init__(self, cfg: DecoderConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        h = cfg.hidden_size

        def lin(i, o):
            return torch_linear(i, o, generator)

        self.fc_in = lin(cfg.dim_embed, h)
        self.blocks = nn.ModuleList(lin(h, h) for _ in range(cfg.n_blocks - 1))
        self.sigma_out = lin(h, 1)
        self.fc_z_view = lin(cfg.z_dim, h)
        self.feat_view = lin(h, h)
        self.fc_view = lin(cfg.dim_embed_view, h)
        self.feat_out = lin(h, cfg.rgb_out_dim)
        if cfg.z_dim > 0:
            self.fc_z = lin(cfg.z_dim, h)
        if cfg.n_skips > 0:
            self.fc_z_skips = nn.ModuleList(lin(cfg.z_dim, h) for _ in range(cfg.n_skips))
            self.fc_p_skips = nn.ModuleList(lin(cfg.dim_embed, h) for _ in range(cfg.n_skips))
        if cfg.use_viewdirs and cfg.n_blocks_view > 1:
            # (dim_embed_view + h) -> h, applied to the h-wide features: the
            # JAX package's shapes, which fail there and here alike
            self.blocks_view = nn.ModuleList(lin(cfg.dim_embed_view + h, h)
                                             for _ in range(cfg.n_blocks_view - 1))
        if cfg.positional_encoding == "gauss":
            self.B_pos = nn.Parameter(cfg.gauss_std * normal((cfg.gauss_dim_pos * 3, 3),
                                                             generator))
            self.B_view = nn.Parameter(cfg.gauss_std * normal((cfg.gauss_dim_view * 3, 3),
                                                              generator))
        if cfg.positional_encoding == "hash":
            spec = cfg.hash_spec
            self.hash_table = nn.Parameter(hash_table(spec.table_size, spec.level_dim, generator))

    def encode(self, x: torch.Tensor, views: bool) -> torch.Tensor:
        cfg = self.cfg
        if cfg.positional_encoding == "gauss":
            b = self.B_view if views else self.B_pos
            proj = (x / cfg.downscale_p_by) @ (math.pi * b.t())
            return torch.cat([torch.sin(proj), torch.cos(proj)], -1)
        if cfg.positional_encoding == "hash":
            if views:
                return sh_encode(x, degree=cfg.sh_degree)
            return _encode_hash(x, self.hash_table, cfg.hash_spec, cfg.hash_div)
        n_freq = cfg.n_freq_posenc_views if views else cfg.n_freq_posenc
        return positional_encoding(x * (2.0 / cfg.downscale_p_by), n_freq)

    def forward(self, pts: torch.Tensor, ray_d: Optional[torch.Tensor],
                z_shape: Optional[torch.Tensor],
                z_app: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        enc = self.encode(pts, views=False)
        net = self.fc_in(enc)
        if cfg.z_dim > 0 and z_shape is not None:
            net = net + self.fc_z(z_shape)[:, None, :]
        net = F.relu(net)
        skip_idx = 0
        for idx, layer in enumerate(self.blocks):
            net = F.relu(layer(net))
            if (idx + 1) in cfg.skips and idx < len(self.blocks) - 1:
                net = net + self.fc_z_skips[skip_idx](z_shape)[:, None, :]
                net = net + self.fc_p_skips[skip_idx](enc)
                skip_idx += 1
        sigma = self.sigma_out(net)[..., 0]

        net = self.feat_view(net) + self.fc_z_view(z_app)[:, None, :]
        if cfg.use_viewdirs and ray_d is not None:
            net = net + self.fc_view(self.encode(_unit_rays(ray_d), views=True))
            net = F.relu(net)
            for layer in getattr(self, "blocks_view", ()):
                net = F.relu(layer(net))
        feat = self.feat_out(net)
        if cfg.final_sigmoid_activation:
            feat = torch.sigmoid(feat)
        return feat, sigma


@dataclass(frozen=True)
class SmallDecoderConfig:
    hidden_size: int = 64
    n_blocks: int = 3
    n_blocks_view: int = 4
    geo_feat_dim: int = 15
    z_dim: int = 64
    rgb_out_dim: int = 128
    final_sigmoid_activation: bool = False
    hash_spec: HashGridSpec = field(default_factory=giraffe_hash_spec)
    sh_degree: int = 4
    hash_div: float = 15.0

    @property
    def dim_embed(self) -> int:
        return self.hash_spec.output_dim

    @property
    def dim_embed_view(self) -> int:
        return sh_output_dim(self.sh_degree)


class SmallDecoder(nn.Module):
    """The NGP-style sigma net (hash encode + ``z_shape``) and colour net
    (SH of the ray + ``z_app``, then the geometry features)."""

    def __init__(self, cfg: SmallDecoderConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        h = cfg.hidden_size
        dims = [cfg.dim_embed] + [h] * (cfg.n_blocks - 1) + [1 + cfg.geo_feat_dim]
        self.sigma_layers = nn.ModuleList(torch_linear(dims[i], dims[i + 1], generator)
                                          for i in range(cfg.n_blocks))
        dims = ([cfg.dim_embed_view + cfg.geo_feat_dim] + [h] * (cfg.n_blocks_view - 1)
                + [cfg.rgb_out_dim])
        self.color_layers = nn.ModuleList(torch_linear(dims[i], dims[i + 1], generator)
                                          for i in range(cfg.n_blocks_view))
        spec = cfg.hash_spec
        self.hash_table = nn.Parameter(hash_table(spec.table_size, spec.level_dim, generator))
        self.fc_z = torch_linear(cfg.z_dim, cfg.dim_embed, generator)
        self.fc_z_view = torch_linear(cfg.z_dim, cfg.dim_embed_view, generator)

    def forward(self, pts: torch.Tensor, ray_d: Optional[torch.Tensor],
                z_shape: Optional[torch.Tensor],
                z_app: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        h = _encode_hash(pts, self.hash_table, cfg.hash_spec, cfg.hash_div)
        if z_shape is not None:
            h = h + self.fc_z(z_shape)[:, None, :]
        for i, layer in enumerate(self.sigma_layers):
            h = layer(h)
            if i < len(self.sigma_layers) - 1:
                h = F.relu(h)
        sigma, geo_feat = h[..., 0], h[..., 1:]
        if ray_d is not None:
            denc = sh_encode(_unit_rays(ray_d), degree=cfg.sh_degree)
        else:
            denc = pts.new_zeros(pts.shape[:-1] + (cfg.dim_embed_view,))
        if z_app is not None:
            denc = denc + self.fc_z_view(z_app)[:, None, :]
        c = torch.cat([denc, geo_feat], -1)
        for i, layer in enumerate(self.color_layers):
            c = layer(c)
            if i < len(self.color_layers) - 1:
                c = F.relu(c)
        if cfg.final_sigmoid_activation:
            c = torch.sigmoid(c)
        return c, sigma
