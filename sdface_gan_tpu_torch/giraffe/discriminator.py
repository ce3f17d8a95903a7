"""GIRAFFE / gan2d discriminators, port of ``sdface_gan_tpu/giraffe/discriminator.py``.

* :class:`DCDiscriminator` - the DCGAN pyramid (4x4 stride-2 convs without
  bias, leaky-ReLU 0.2, a 4x4 valid ``conv_out``); it returns the logits
  and the last feature map flattened in the JAX package's NHWC order, which
  the VAE encoder step's feature matching compares;
* :class:`ResnetDiscriminator` - the GAN-stability ResNet discriminator;
* :class:`ResnetBlock` - its block, shared with the gan2d generator.

Images come channel-last [B, H, W, 3] in [0, 1]; the convolutions run
NCHW.  Layers are initialised as torch initialises them (U(+-1/sqrt(fan_in))
for weight and bias, the JAX ``_torch_conv``), drawn from an explicit
``torch.Generator``.  ``utils.convert.jax_dc_disc_params_to_state_dict`` /
``jax_resnet_disc_params_to_state_dict`` carry JAX's trees across.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..encoder._layers import uniform_conv, uniform_linear


def _seeded(generator: Optional[torch.Generator]) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


@dataclass(frozen=True)
class DCDiscConfig:
    in_dim: int = 3
    n_feat: int = 512
    img_size: int = 64

    @property
    def n_layers(self) -> int:
        return int(math.log2(self.img_size) - 2)

    def channels(self) -> List[Tuple[int, int]]:
        n = self.n_layers
        chans = [(self.in_dim, self.n_feat // (2 ** (n - 1)))]
        for i in range(1, n):
            chans.append((self.n_feat // (2 ** (n - i)), self.n_feat // (2 ** (n - 1 - i))))
        return chans


def nhwc_flatten(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H * W * C], the order in which JAX flattens NHWC."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class DCDiscriminator(nn.Module):
    """x [B, H, W, 3] -> (logits [B, 1], features [B, n_feat * 4 * 4])."""

    def __init__(self, cfg: DCDiscConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        generator = _seeded(generator)
        self.cfg = cfg
        self.blocks = nn.ModuleList(
            uniform_conv(ic, oc, 4, stride=2, padding=1, bias=False, generator=generator)
            for ic, oc in cfg.channels())
        self.conv_out = uniform_conv(cfg.n_feat, 1, 4, bias=False, generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x.permute(0, 3, 1, 2)
        for block in self.blocks:
            h = F.leaky_relu(block(h), 0.2)
        return self.conv_out(h).reshape(x.shape[0], 1), nhwc_flatten(h)


class ResnetBlock(nn.Module):
    """GAN-stability block, NCHW: ``x_s + 0.1 * dx`` with leaky-ReLU
    pre-activations; a biasless 1x1 ``conv_s`` only when fin != fout."""

    def __init__(self, fin: int, fout: int, generator: torch.Generator):
        super().__init__()
        fhidden = min(fin, fout)
        self.conv_0 = uniform_conv(fin, fhidden, 3, padding=1, generator=generator)
        self.conv_1 = uniform_conv(fhidden, fout, 3, padding=1, generator=generator)
        if fin != fout:
            self.conv_s = uniform_conv(fin, fout, 1, bias=False, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dx = self.conv_0(F.leaky_relu(x, 0.2))
        dx = self.conv_1(F.leaky_relu(dx, 0.2))
        xs = self.conv_s(x) if hasattr(self, "conv_s") else x
        return xs + 0.1 * dx


@dataclass(frozen=True)
class ResnetDiscConfig:
    img_size: int = 64
    nfilter: int = 16
    nfilter_max: int = 512
    s0: int = 4

    @property
    def n_layers(self) -> int:
        return int(math.log2(self.img_size / self.s0))

    @property
    def nf0(self) -> int:
        return min(self.nfilter_max, self.nfilter * 2 ** self.n_layers)

    def block_channels(self) -> List[Tuple[int, int]]:
        nf, nf_max = self.nfilter, self.nfilter_max
        chans = [(nf, nf)]
        for i in range(self.n_layers):
            chans.append((min(nf * 2 ** i, nf_max), min(nf * 2 ** (i + 1), nf_max)))
        return chans


def avg_pool_3_2_1(x: torch.Tensor) -> torch.Tensor:
    """3x3 average pool, stride 2, padding 1, dividing by 9 at the border too."""
    return F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=True)


class ResnetDiscriminator(nn.Module):
    """x [B, H, W, 3] -> logits [B, 1]: ``conv_img``, a ResNet block, then
    (3/2/1 pool, block) per level, leaky-ReLU and ``fc`` over the NHWC
    flatten."""

    def __init__(self, cfg: ResnetDiscConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        generator = _seeded(generator)
        self.cfg = cfg
        self.conv_img = uniform_conv(3, cfg.nfilter, 3, padding=1, generator=generator)
        self.blocks = nn.ModuleList(ResnetBlock(fin, fout, generator)
                                    for fin, fout in cfg.block_channels())
        self.fc = uniform_linear(cfg.nf0 * cfg.s0 * cfg.s0, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.blocks[0](self.conv_img(x.permute(0, 3, 1, 2)))
        for block in self.blocks[1:]:
            out = block(avg_pool_3_2_1(out))
        return self.fc(F.leaky_relu(nhwc_flatten(out), 0.2))
