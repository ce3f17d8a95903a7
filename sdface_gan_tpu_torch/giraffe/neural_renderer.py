"""GIRAFFE 2D neural renderer, port of ``sdface_gan_tpu/giraffe/neural_renderer.py``:
the 16^2 feature map up to the image through conv layers (nearest x2 for
features; bilinear x2, reflect pad and a [1,2,1] x [1,2,1] / 16 blur for
RGB) with the RGB skip sum and a final sigmoid.  NCHW inside; takes and
returns channel-last tensors, as the JAX function does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..encoder._layers import uniform_conv


@dataclass(frozen=True)
class NeuralRendererConfig:
    n_feat: int = 128
    input_dim: int = 128
    out_dim: int = 3
    final_actvn: bool = True
    min_feat: int = 32
    img_size: int = 64
    use_rgb_skip: bool = True
    upsample_feat: str = "nn"  # 'nn' | 'bilinear'
    upsample_rgb: str = "bilinear"
    use_norm: bool = False

    @property
    def n_blocks(self) -> int:
        return int(math.log2(self.img_size) - 4)

    def feat_channels(self) -> List[int]:
        return [self.n_feat] + [max(self.n_feat // (2 ** (i + 1)), self.min_feat)
                                for i in range(self.n_blocks)]


def upsample_nn(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def upsample_bilinear_blur(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 (``align_corners=False``), reflect pad, depthwise 3x3
    [1,2,1] x [1,2,1] / 16 blur of an NCHW tensor."""
    up = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    up = F.pad(up, (1, 1, 1, 1), mode="reflect")
    k1 = torch.tensor([1.0, 2.0, 1.0], dtype=x.dtype, device=x.device)
    k = (k1[:, None] * k1[None, :]) / 16.0
    c = x.shape[1]
    return F.conv2d(up, k.expand(c, 1, 3, 3), groups=c)


class NeuralRenderer(nn.Module):
    """[B, 16, 16, input_dim] features -> [B, img_size, img_size, 3] in [0, 1]."""

    def __init__(self, cfg: NeuralRendererConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        chans = cfg.feat_channels()

        def conv(i, o, k):
            return uniform_conv(i, o, k, padding=k // 2, generator=generator)

        if cfg.n_feat != cfg.input_dim:
            self.conv_in = conv(cfg.input_dim, cfg.n_feat, 1)
        self.conv_layers = nn.ModuleList(conv(chans[i], chans[i + 1], 3)
                                         for i in range(cfg.n_blocks))
        if cfg.use_rgb_skip:
            self.conv_rgb = nn.ModuleList(
                [conv(cfg.input_dim, cfg.out_dim, 3)]
                + [conv(chans[i + 1], cfg.out_dim, 3) for i in range(cfg.n_blocks)])
        else:
            self.conv_rgb = conv(chans[-1], 3, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        up_feat = upsample_nn if cfg.upsample_feat == "nn" else upsample_bilinear_blur
        up_rgb = upsample_nn if cfg.upsample_rgb == "nn" else upsample_bilinear_blur
        x = x.permute(0, 3, 1, 2)
        net = self.conv_in(x) if hasattr(self, "conv_in") else x
        rgb = up_rgb(self.conv_rgb[0](x)) if cfg.use_rgb_skip else None
        for idx, layer in enumerate(self.conv_layers):
            net = F.leaky_relu(layer(up_feat(net)), 0.2)
            if cfg.use_rgb_skip:
                rgb = rgb + self.conv_rgb[idx + 1](net)
                if idx < len(self.conv_layers) - 1:
                    rgb = up_rgb(rgb)
        if not cfg.use_rgb_skip:
            rgb = self.conv_rgb(net)
        if cfg.final_actvn:
            rgb = torch.sigmoid(rgb)
        return rgb.permute(0, 2, 3, 1)
