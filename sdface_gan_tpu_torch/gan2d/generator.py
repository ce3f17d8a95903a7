"""GAN-stability ResNet generator of the gan2d baseline, port of
``sdface_gan_tpu/gan2d/generator.py``: z -> fc -> a 4x4 map -> (ResNet
block, nearest x2) per level -> a last block -> leaky-ReLU -> 3x3 conv ->
tanh.  Returns channel-last images [B, size, size, 3] in [-1, 1]; the fc's
outputs are in JAX's (h, w, c) order, so
``utils.convert.jax_gan2d_params_to_state_dict`` only transposes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..encoder._layers import uniform_conv, uniform_linear
from ..giraffe.discriminator import ResnetBlock
from ..giraffe.neural_renderer import upsample_nn


@dataclass(frozen=True)
class Gan2dGeneratorConfig:
    z_dim: int = 256
    size: int = 64
    nfilter: int = 16
    nfilter_max: int = 512
    s0: int = 4

    @property
    def n_layers(self) -> int:
        return int(math.log2(self.size / self.s0))

    @property
    def nf0(self) -> int:
        return min(self.nfilter_max, self.nfilter * 2 ** self.n_layers)

    def block_channels(self) -> List[Tuple[int, int]]:
        nf, nf_max, n = self.nfilter, self.nfilter_max, self.n_layers
        chans = [(min(nf * 2 ** (n - i), nf_max), min(nf * 2 ** (n - i - 1), nf_max))
                 for i in range(n)]
        return chans + [(nf, nf)]


class Gan2dGenerator(nn.Module):
    """z [B, z_dim] -> images [B, size, size, 3] in [-1, 1]."""

    def __init__(self, cfg: Gan2dGeneratorConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.fc = uniform_linear(cfg.z_dim, cfg.nf0 * cfg.s0 * cfg.s0, generator=generator)
        self.blocks = nn.ModuleList(ResnetBlock(fin, fout, generator)
                                    for fin, fout in cfg.block_channels())
        self.conv_img = uniform_conv(cfg.nfilter, 3, 3, padding=1, generator=generator)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        out = self.fc(z).reshape(z.shape[0], cfg.s0, cfg.s0, cfg.nf0).permute(0, 3, 1, 2)
        for block in self.blocks[:-1]:
            out = upsample_nn(block(out))
        out = self.conv_img(F.leaky_relu(self.blocks[-1](out), 0.2))
        return torch.tanh(out).permute(0, 2, 3, 1)
