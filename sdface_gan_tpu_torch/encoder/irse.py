"""ir_se-50 backbone and the pSp GradualStyleEncoder, port of
``sdface_gan_tpu/encoder/irse.py:29-230``.

The ArcFace face-recognition backbone (SE-augmented IR bottlenecks,
``IR50_BLOCKS``) and the FPN-style pSp encoder that taps it after body
blocks 6 / 20 / 23.  Modules carry upstream's state-dict names
(``input_layer.{0,1,2}``, ``body.{i}.res_layer.{0..5}`` with
``res_layer.5.fc{1,2}``, ``body.{i}.shortcut_layer.{0,1}``,
``output_layer.{0,3,4}``), so a ``model_ir_se50.pth`` loads with
``load_state_dict``: the keys the JAX ``import_irse_state`` reads.

* Batch norms use their stored statistics, also while pSp trains
  (``StatNorm``; the statistics are parameters, as in the JAX tree).
* A block whose input and output widths match takes the ``MaxPool2d(1, s)``
  shortcut, which is strided slicing.
* The embedding head flattens in NCHW order before ``output_layer.3``, as
  the JAX head does after its transpose.
* The FPN's ``_upsample_to`` is ``jax.image.resize(bilinear)`` upsampling:
  half-pixel centres, ``align_corners=False`` (not upstream pSp's
  ``align_corners=True``).

Images come channel-last [B, H, W, 3] in [-1, 1].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ._layers import StatNorm, uniform_conv, uniform_linear

# ir-50 block plan: (in, depth, num_units) per stage (reference
# ``helpers.py get_blocks(50)``).
IR50_BLOCKS = [(64, 64, 3), (64, 128, 4), (128, 256, 14), (256, 512, 3)]
# body blocks after which the pSp FPN taps the backbone (c1, c2, c3)
FPN_TAPS = (6, 20, 23)
# squeeze-excite channel reduction
SE_REDUCT = 16


@dataclass(frozen=True)
class IRSEConfig:
    psp_input_size: int = 256  # pSp GradualStyleEncoder input (FPN taps)
    style_count: int = 6
    coarse_ind: int = 1
    middle_ind: int = 3


def _prelu(ch: int) -> nn.PReLU:
    return nn.PReLU(ch, init=0.25)


class SEModule(nn.Module):
    def __init__(self, ch: int, generator: torch.Generator):
        super().__init__()
        self.fc1 = uniform_conv(ch, ch // SE_REDUCT, 1, bias=False, generator=generator)
        self.fc2 = uniform_conv(ch // SE_REDUCT, ch, 1, bias=False, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        se = torch.mean(x, dim=(2, 3), keepdim=True)
        se = torch.sigmoid(self.fc2(F.relu(self.fc1(se))))
        return x * se


class BottleneckIRSE(nn.Module):
    def __init__(self, in_ch: int, depth: int, stride: int, generator: torch.Generator):
        super().__init__()
        if in_ch == depth:
            self.shortcut_layer = nn.MaxPool2d(1, stride)
        else:
            self.shortcut_layer = nn.Sequential(
                uniform_conv(in_ch, depth, 1, stride=stride, bias=False, generator=generator),
                StatNorm(depth))
        self.res_layer = nn.Sequential(
            StatNorm(in_ch),
            uniform_conv(in_ch, depth, 3, padding=1, bias=False, generator=generator),
            _prelu(depth),
            uniform_conv(depth, depth, 3, stride=stride, padding=1, bias=False,
                         generator=generator),
            StatNorm(depth),
            SEModule(depth, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.res_layer(x) + self.shortcut_layer(x)


def ir50_strides() -> List[int]:
    """Per-block strides of the ir-50 body: 2 on each stage head, else 1."""
    out: List[int] = []
    for _, _, num in IR50_BLOCKS:
        out.extend([2] + [1] * (num - 1))
    return out


class IRSEBackbone(nn.Module):
    """The ir_se-50 net: ``forward`` gives the face-identity embedding
    [B, 512] of 112^2 crops (reference ``model_irse.py:10-84``); the pSp
    encoder runs ``input_layer`` and ``body`` alone."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.input_layer = nn.Sequential(
            uniform_conv(3, 64, 3, padding=1, bias=False, generator=generator),
            StatNorm(64), _prelu(64))
        strides = iter(ir50_strides())
        blocks = []
        for in_ch, depth, num in IR50_BLOCKS:
            blocks.append(BottleneckIRSE(in_ch, depth, next(strides), generator))
            for _ in range(num - 1):
                blocks.append(BottleneckIRSE(depth, depth, next(strides), generator))
        self.body = nn.Sequential(*blocks)
        # upstream's [BN, Dropout, Flatten, Linear, BN1d]; dropout is off at
        # inference, which is all this head runs
        self.output_layer = nn.Sequential(
            StatNorm(512), nn.Identity(), nn.Flatten(),
            uniform_linear(512 * 7 * 7, 512, generator=generator), StatNorm(512))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embed(x.permute(0, 3, 1, 2))

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The embedding of NCHW crops."""
        return self.output_layer(self.body(self.input_layer(x)))


class GradualStyleBlock(nn.Module):
    """log2(spatial) stride-2 3x3 convs with leaky ReLU 0.2, then a linear."""

    def __init__(self, in_c: int, out_c: int, spatial: int, generator: torch.Generator):
        super().__init__()
        n_pools = int(np.log2(spatial))
        self.convs = nn.ModuleList(
            uniform_conv(in_c if i == 0 else out_c, out_c, 3, stride=2, padding=1,
                         generator=generator) for i in range(n_pools))
        self.linear = uniform_linear(out_c, out_c, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = F.leaky_relu(conv(x), 0.2)
        return self.linear(x.flatten(1))


class GradualStyleEncoder(nn.Module):
    """x [B, S, S, 3] -> style stack [B, style_count, 512] (reference
    ``psp_encoders.py:97-122``).  The FPN tap resolutions follow the input
    (S/16, S/8, S/4), as in the JAX encoder."""

    def __init__(self, cfg: IRSEConfig = IRSEConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.backbone = IRSEBackbone(generator)
        styles = []
        for i in range(cfg.style_count):
            if i < cfg.coarse_ind:
                spatial = cfg.psp_input_size // 16
            elif i < cfg.middle_ind:
                spatial = cfg.psp_input_size // 8
            else:
                spatial = cfg.psp_input_size // 4
            styles.append(GradualStyleBlock(512, 512, spatial, generator))
        self.styles = nn.ModuleList(styles)
        self.latlayer1 = uniform_conv(256, 512, 1, generator=generator)
        self.latlayer2 = uniform_conv(128, 512, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = self.backbone.input_layer(x.permute(0, 3, 1, 2))
        taps = []
        for i, block in enumerate(self.backbone.body):
            h = block(h)
            if i in FPN_TAPS:
                taps.append(h)
        c1, c2, c3 = taps
        latents = [self.styles[j](c3) for j in range(cfg.coarse_ind)]
        p2 = _upsample_to(c3, c2) + self.latlayer1(c2)
        latents += [self.styles[j](p2) for j in range(cfg.coarse_ind, cfg.middle_ind)]
        p1 = _upsample_to(p2, c1) + self.latlayer2(c1)
        latents += [self.styles[j](p1) for j in range(cfg.middle_ind, cfg.style_count)]
        return torch.stack(latents, dim=1)


def _upsample_to(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Bilinear upsampling with half-pixel centres to ``like``'s size."""
    return F.interpolate(x, size=like.shape[-2:], mode="bilinear", align_corners=False)
