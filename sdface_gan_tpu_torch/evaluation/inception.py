"""InceptionV3 of the FID variant, port of ``sdface_gan_tpu/evaluation/inception.py``.

The TF-parity InceptionV3 of pytorch-fid (the reference's
``im2scene/inception.py``), whose pool3 (2048-d) activations define FID.
The FID variant differs from stock InceptionV3 in its pooling: the
average pools inside the A, C and E blocks leave the padding out of the
count (``count_include_pad=False``), and the last E block's pooling
branch is a max pool.  BatchNorm's eps is 1e-3.

Modules carry pytorch-fid's names (``Conv2d_1a_3x3.conv.weight``,
``Mixed_5b.branch1x1.bn.running_var``, ...), so a pytorch-fid state dict
(``pt_inception-2015-12-05``) loads with :func:`load_inception`.  Without
weights the network draws a random init from an explicit
``torch.Generator`` (the JAX package's distributions), so the FID
machinery runs and is testable; such a FID is not comparable with
published ones.

Input: images [B, H, W, 3] in [-1, 1] (channel-last, as the generator
returns them), resized to 299 with bilinear half-pixel sampling, with
antialiasing when it shrinks (``jax.image.resize(method="bilinear")``).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

INPUT_SIZE = 299


class BasicConv2d(nn.Module):
    """conv (no bias) + batchnorm (eps 1e-3, running statistics) + relu."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 64, 1)
        self.branch5x5_1 = BasicConv2d(in_ch, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(in_ch, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, b3, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(in_ch, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(in_ch, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for layer in (self.branch7x7dbl_1, self.branch7x7dbl_2, self.branch7x7dbl_3,
                      self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = layer(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(in_ch, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for layer in (self.branch7x7x3_1, self.branch7x7x3_2, self.branch7x7x3_3,
                      self.branch7x7x3_4):
            b7 = layer(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    """``max_pool``: the last block's pooling branch (pytorch-fid's
    ``FIDInceptionE_2``); otherwise the average pool without the padding."""

    def __init__(self, in_ch: int, max_pool: bool):
        super().__init__()
        self.max_pool = max_pool
        self.branch1x1 = BasicConv2d(in_ch, 320, 1)
        self.branch3x3_1 = BasicConv2d(in_ch, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(in_ch, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(in_ch, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        pooled = F.max_pool2d(x, 3, stride=1, padding=1) if self.max_pool else _avg_pool(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(pooled)], 1)


class InceptionV3(nn.Module):
    """The FID InceptionV3 up to pool3.  ``forward(images)`` takes [B, H, W, 3]
    in [-1, 1] and returns [B, 2048] f32.  Built in eval mode (BatchNorm
    uses its running statistics) on ``device`` (default the card; raises
    without one)."""

    def __init__(self, device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, max_pool=False)
        self.Mixed_7c = InceptionE(2048, max_pool=True)
        self.reset_parameters(generator if generator is not None
                              else torch.Generator().manual_seed(0))
        self.eval().to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random init, the JAX package's distributions: conv weights
        N(0, 2 / fan_in), BatchNorm at identity (scale 1, bias 0, mean 0,
        var 1)."""
        for m in self.modules():
            if isinstance(m, BasicConv2d):
                w = m.conv.weight
                std = math.sqrt(2.0 / (w.shape[1] * w.shape[2] * w.shape[3]))
                w.copy_(std * torch.randn(w.shape, generator=generator))
                m.bn.reset_parameters()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.float().permute(0, 3, 1, 2)
        # bilinear with half-pixel centres, antialiased when it shrinks:
        # jax.image.resize(method="bilinear")
        shrink = x.shape[-2] > INPUT_SIZE or x.shape[-1] > INPUT_SIZE
        x = F.interpolate(x, size=(INPUT_SIZE, INPUT_SIZE), mode="bilinear",
                          align_corners=False, antialias=shrink)
        for layer in (self.Conv2d_1a_3x3, self.Conv2d_2a_3x3, self.Conv2d_2b_3x3):
            x = layer(x)
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a,
                      self.Mixed_6b, self.Mixed_6c, self.Mixed_6d, self.Mixed_6e,
                      self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        return torch.mean(x, dim=(2, 3))


def load_inception(weights_path: Optional[str] = None,
                   device: Union[str, torch.device] = "cuda",
                   generator: Optional[torch.Generator] = None) -> InceptionV3:
    """The FID Inception on ``device``: a pytorch-fid checkpoint's weights
    when ``weights_path`` is given (read with ``weights_only=True``; its
    classifier and auxiliary head are left out), else a random init from
    ``generator`` (seed 0 when None)."""
    model = InceptionV3(device=device, generator=generator)
    if weights_path is not None:
        state = torch.load(weights_path, map_location="cpu", weights_only=True)
        ours = model.state_dict()
        missing = [k for k in ours if k not in state and not k.endswith("num_batches_tracked")]
        if missing:
            raise KeyError(f"{weights_path} lacks {len(missing)} FID Inception tensors, "
                           f"e.g. {missing[:3]}")
        model.load_state_dict({k: state[k] for k in ours if k in state}, strict=False)
    return model


def init_inception(generator: Optional[torch.Generator] = None,
                   device: Union[str, torch.device] = "cuda") -> InceptionV3:
    """A randomly initialized FID Inception (machinery testing only)."""
    return InceptionV3(device=device, generator=generator)


def inception_pool3(model: InceptionV3, images: torch.Tensor) -> torch.Tensor:
    """pool3 activations [B, 2048] of images [B, H, W, 3] in [-1, 1]."""
    return model(images)
