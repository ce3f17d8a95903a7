"""Discriminators of the SDF pipeline, port of
``sdface_gan_tpu/models/discriminator.py``.

* ``VolumeRenderDiscriminator`` - the stage-A D on 64^2 thumbs: CoordConv
  residual blocks and a 3-channel head [GAN logit, azim, elev];
* ``StyleDiscriminator`` - the stage-B StyleGAN2 D on full-res images:
  blur-downsampled residual blocks and minibatch stddev.

Both take channel-last images [B, H, W, 3], as the JAX functions do, and
run NCHW inside.  Parameter names follow the JAX parameter tree (``w`` ->
``weight``, ``b`` -> ``bias``, ``act_bias`` stays), so
``utils.convert.jax_disc_params_to_state_dict`` maps one onto the other.
The StyleGAN2 D flattens its last feature map in (c, h, w) order, as the
reference torch D does; the JAX D flattens (h, w, c), and the converter
permutes ``final_linear1``'s input axis accordingly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_act import fused_leaky_relu
from ..ops.upfirdn2d import blur
from ..parallel.mesh import active, all_gather_batch
from .init import uniform
from .stylegan2 import BLUR_KERNEL, EqualConv2d, EqualLinear, channel_table

# Stage-A channel schedule (reference ``sdf_model.py:1359-1367``).
VOLRENDER_CHANNELS = {2: 400, 4: 400, 8: 400, 16: 400, 32: 256, 64: 128, 128: 64}


def add_coords(x: torch.Tensor) -> torch.Tensor:
    """Append normalized (y, x) coordinate channels in [-1, 1] to [B, C, H, W]."""
    b, _, h, w = x.shape
    yy = torch.linspace(-1.0, 1.0, h, dtype=x.dtype, device=x.device)
    xx = torch.linspace(-1.0, 1.0, w, dtype=x.dtype, device=x.device)
    yy = yy[None, None, :, None].expand(b, 1, h, w)
    xx = xx[None, None, None, :].expand(b, 1, h, w)
    return torch.cat([x, yy, xx], dim=1)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 2)


class VRDConv(nn.Module):
    """A torch-initialized conv (U(+-1/sqrt(fan_in)) weight and bias) that is
    either activated (biasless, then FusedLeakyReLU with scale 1 and a
    U(+-sqrt(1/(in k k))) bias) or plain with a bias.  ``coords`` adds the
    two CoordConv channels to the input (CoordConvLayer, always activated,
    padding k // 2)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, activate: bool,
                 coords: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        conv_in = in_ch + 2 if coords else in_ch
        bound = 1.0 / math.sqrt(conv_in * k * k)
        self.weight = nn.Parameter(uniform((out_ch, conv_in, k, k), bound, generator))
        if activate:
            self.act_bias = nn.Parameter(uniform((out_ch,), math.sqrt(1.0 / (in_ch * k * k)),
                                                 generator))
        else:
            self.bias = nn.Parameter(uniform((out_ch,), bound, generator))
        self.coords = coords
        self.padding = k // 2 if coords and k > 2 else 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.coords:
            x = add_coords(x)
        out = F.conv2d(x, self.weight, getattr(self, "bias", None), padding=self.padding)
        if hasattr(self, "act_bias"):
            out = fused_leaky_relu(out, self.act_bias, scale=1.0)
        return out


@dataclass(frozen=True)
class VolumeRenderDiscConfig:
    in_res: int = 64
    viewpoint_head: bool = True

    @property
    def final_out(self) -> int:
        return 3 if self.viewpoint_head else 1

    def block_channels(self) -> List[Tuple[int, int]]:
        log = int(math.log2(self.in_res))
        chans, in_ch = [], VOLRENDER_CHANNELS[self.in_res]
        for i in range(log - 1, 0, -1):
            chans.append((in_ch, VOLRENDER_CHANNELS[2**i]))
            in_ch = VOLRENDER_CHANNELS[2**i]
        return chans


class VRDBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = VRDConv(in_ch, out_ch, 3, True, coords=True, generator=generator)
        self.conv2 = VRDConv(out_ch, out_ch, 3, True, coords=True, generator=generator)
        if in_ch != out_ch:
            self.skip = VRDConv(in_ch, out_ch, 1, False, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _avg_pool2(self.conv2(self.conv1(x)))
        skip = _avg_pool2(x)
        if hasattr(self, "skip"):
            skip = self.skip(skip)
        return (h + skip) / math.sqrt(2.0)


class VolumeRenderDiscriminator(nn.Module):
    """Stage-A D (reference ``sdf_model.py:1326-1398``)."""

    def __init__(self, cfg: VolumeRenderDiscConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        blocks = cfg.block_channels()
        self.conv_in = VRDConv(3, VOLRENDER_CHANNELS[cfg.in_res], 1, True, generator=generator)
        self.blocks = nn.ModuleList([VRDBlock(i, o, generator=generator) for i, o in blocks])
        self.final = VRDConv(blocks[-1][1], cfg.final_out, 2, False, generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """[B, H, W, 3] thumbs -> (GAN logits [B, 1], viewpoint [B, 2] | None)."""
        out = self.conv_in(x.permute(0, 3, 1, 2))
        for block in self.blocks:
            out = block(out)
        out = self.final(out).reshape(out.shape[0], -1)  # [B, final_out]
        return out[:, :1], (out[:, 1:] if self.cfg.viewpoint_head else None)


@dataclass(frozen=True)
class StyleDiscConfig:
    size: int = 256
    channel_multiplier: int = 2
    channel_base: int = 512
    stddev_group: int = 4
    stddev_feat: int = 1

    @property
    def channels(self) -> Dict[int, int]:
        return channel_table(self.channel_multiplier, self.channel_base)

    def block_channels(self) -> List[Tuple[int, int]]:
        chans = self.channels
        out, in_ch = [], chans[self.size]
        for i in range(int(math.log2(self.size)), 2, -1):
            out.append((in_ch, chans[2 ** (i - 1)]))
            in_ch = chans[2 ** (i - 1)]
        return out


class ConvLayer(nn.Module):
    """StyleGAN2 ConvLayer (reference ``sdf_model.py:846-880``): optional FIR
    blur and stride-2 equalized conv, then fused leaky ReLU with a zero-init
    bias when activated."""

    def __init__(self, in_ch: int, out_ch: int, k: int, downsample: bool = False,
                 activate: bool = True, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = EqualConv2d(in_ch, out_ch, k, stride=2 if downsample else 1,
                                padding=0 if downsample else k // 2,
                                bias=bias and not activate, generator=generator)
        if activate:
            self.act_bias = nn.Parameter(torch.zeros(out_ch))
        self.blur_pad = None
        if downsample:
            pb = (len(BLUR_KERNEL) - 2) + (k - 1)
            self.blur_pad = ((pb + 1) // 2, pb // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.blur_pad is not None:
            x = blur(x, BLUR_KERNEL, self.blur_pad)
        out = self.conv(x)
        if hasattr(self, "act_bias"):
            out = fused_leaky_relu(out, self.act_bias)
        return out


class StyleDiscBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = ConvLayer(in_ch, in_ch, 3, generator=generator)
        self.conv2 = ConvLayer(in_ch, out_ch, 3, downsample=True, generator=generator)
        self.skip = ConvLayer(in_ch, out_ch, 1, downsample=True, activate=False, bias=False,
                              generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (self.conv2(self.conv1(x)) + self.skip(x)) / math.sqrt(2.0)


def minibatch_stddev(x: torch.Tensor, group_size: int = 4, feat: int = 1) -> torch.Tensor:
    """Append the group-averaged stddev channel to [B, C, H, W].  The group
    is the largest divisor of the batch up to ``group_size``, as in the JAX
    package (any batch size works; group 1 gives a zero-ish channel).
    Inside a data-parallel step the groups are strided over the global
    batch, as in JAX's global program: the activations of every rank are
    gathered (differentiably, for R1's double backward) and the rank keeps
    its rows of the channel."""
    mesh = active()
    local, x = x, all_gather_batch(x)
    b, c, h, w = x.shape
    group = min(b, group_size)
    while b % group:
        group -= 1
    g = x.reshape(group, b // group, feat, c // feat, h, w)
    stddev = torch.sqrt(torch.var(g, dim=0, correction=0) + 1e-8)
    stddev = torch.mean(stddev, dim=(2, 3, 4))  # [b/group, feat]
    stddev = stddev.reshape(b // group, feat, 1, 1).repeat(group, 1, h, w)
    if mesh is not None:
        stddev = stddev[mesh.rows(b)]
    return torch.cat([local, stddev], dim=1)


class StyleDiscriminator(nn.Module):
    """Stage-B D (reference ``sdf_model.py:1402-1509``)."""

    def __init__(self, cfg: StyleDiscConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        chans, blocks = cfg.channels, cfg.block_channels()
        self.conv_in = ConvLayer(3, chans[cfg.size], 1, generator=generator)
        self.blocks = nn.ModuleList([StyleDiscBlock(i, o, generator=generator)
                                     for i, o in blocks])
        self.final_conv = ConvLayer(blocks[-1][1] + 1, chans[4], 3, generator=generator)
        self.final_linear1 = EqualLinear(chans[4] * 4 * 4, chans[4], activate=True,
                                         generator=generator)
        self.final_linear2 = EqualLinear(chans[4], 1, generator=generator)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Conv trunk, minibatch stddev and final conv, flattened (c, h, w)."""
        out = self.conv_in(x.permute(0, 3, 1, 2))
        for block in self.blocks:
            out = block(out)
        out = minibatch_stddev(out, self.cfg.stddev_group, self.cfg.stddev_feat)
        out = self.final_conv(out)
        return out.reshape(out.shape[0], -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, size, size, 3] images -> GAN logits [B, 1]."""
        return self.final_linear2(self.final_linear1(self.features(x)))
