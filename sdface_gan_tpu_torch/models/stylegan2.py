"""StyleGAN2 decoder (64^2 features -> image), port of
``sdface_gan_tpu/models/stylegan2.py``.

Equalized-lr linears, modulated conv, noise injection, StyledConv/ToRGB
and the Decoder.  The decoder runs NCHW inside; its public function
:func:`apply_decoder` takes and returns channel-last tensors, as the JAX
one does.  Module names follow the reference ``g_ema`` state dict
(``decoder.style.{i}``, ``decoder.conv1.conv.weight`` [1, O, I, k, k],
``decoder.noises.noise_{i}`` [1, 1, r, r], ``decoder.to_rgbs.{i}.bias``
[1, 3, 1, 1]).

Modulated conv uses the commuted form: conv is linear in input and
weight, so ``conv(x, w * s) == conv(x * s, w)`` for a per-in-channel s,
and demodulation is a per-(sample, out-channel) scale of the output.  One
batched conv with shared weights replaces the reference's grouped conv.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_act import fused_leaky_relu
from ..ops.upfirdn2d import blur, upsample2d
from ..parallel.mesh import batch_draw
from .init import mapping_linear_params, normal

BLUR_KERNEL = (1, 3, 3, 1)


class EqualLinear(nn.Module):
    """Weight stored as N(0,1)/lr_mul, runtime scale ``lr_mul/sqrt(in)``."""

    def __init__(self, in_dim: int, out_dim: int, lr_mul: float = 1.0,
                 bias_init: float = 0.0, activate: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(normal((out_dim, in_dim), generator) / lr_mul)
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init)))
        self.lr_mul = lr_mul
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.activate = activate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.linear(x.to(self.weight.dtype), self.weight * self.scale)
        if self.activate:
            return fused_leaky_relu(out, self.bias * self.lr_mul)
        return out + self.bias * self.lr_mul


class MappingLinear(nn.Module):
    """The renderer mapping's linear layer with leaky-ReLU (scale 1)."""

    def __init__(self, in_dim: int, out_dim: int, is_last: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w, b = mapping_linear_params(in_dim, out_dim, generator, is_last=is_last)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.linear(x.to(self.weight.dtype), self.weight)
        return fused_leaky_relu(out, self.bias, scale=1.0)


class EqualConv2d(nn.Module):
    """Conv with weight N(0,1) [O, I, k, k] and runtime scale 1/sqrt(I*k*k)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(
            normal((out_ch, in_ch, kernel_size, kernel_size), generator))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None
        self.scale = 1.0 / math.sqrt(in_ch * kernel_size * kernel_size)
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight * self.scale
        out = F.conv2d(x.to(w.dtype), w, stride=self.stride, padding=self.padding)
        if self.bias is not None:
            out = out + self.bias[None, :, None, None]
        return out


class PixelNorm(nn.Module):
    """Normalize over the channel axis of [B, C]."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_norm(x)


def pixel_norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-8)


class ModulatedConv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, style_dim: int,
                 demodulate: bool = True, upsample: bool = False,
                 blur_kernel: Tuple[int, ...] = BLUR_KERNEL,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(
            normal((1, out_ch, in_ch, kernel_size, kernel_size), generator))
        self.modulation = EqualLinear(style_dim, in_ch, bias_init=1.0, generator=generator)
        self.in_ch, self.kernel_size = in_ch, kernel_size
        self.demodulate, self.upsample = demodulate, upsample
        self.blur_kernel = blur_kernel

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        """x [B, in, H, W], style [B, style_dim] -> [B, out, H', W']."""
        k = self.kernel_size
        s = self.modulation(style)  # [B, in]
        scale = 1.0 / math.sqrt(self.in_ch * k * k)
        w = self.weight[0] * scale  # [O, I, k, k]
        demod = None
        if self.demodulate:
            w2 = torch.sum((scale * self.weight[0]) ** 2, dim=(2, 3))  # [O, I]
            demod = torch.rsqrt((s**2) @ w2.t() + 1e-8)  # [B, O]
        xs = x.to(w.dtype) * s[:, :, None, None]
        if self.upsample:
            out = F.conv_transpose2d(xs, w.transpose(0, 1), stride=2)
        else:
            out = F.conv2d(xs, w, padding=k // 2)
        if demod is not None:
            out = out * demod[:, :, None, None]
        if self.upsample:
            factor = 2
            pb = (len(self.blur_kernel) - factor) - (k - 1)
            pad = ((pb + 1) // 2 + factor - 1, pb // 2 + 1)
            out = blur(out, self.blur_kernel, pad, upsample_factor=factor)
        return out


class NoiseInjection(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        return x + self.weight * noise


class FusedLeakyReLU(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_leaky_relu(x, self.bias)


class StyledConv(nn.Module):
    """ModConv -> noise injection -> fused leaky ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, style_dim: int,
                 upsample: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, out_ch, kernel_size, style_dim,
                                    upsample=upsample, generator=generator)
        self.noise = NoiseInjection()
        self.activate = FusedLeakyReLU(out_ch)

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``noise`` [B or 1, 1, H, W]; drawn from ``generator`` when None
        and a generator is given, left out when both are None."""
        out = self.conv(x, style)
        if noise is None and generator is not None:
            b, _, h, w = out.shape
            noise = batch_draw(torch.randn, (b, 1, h, w), generator, out.device).to(out.dtype)
        if noise is not None:
            out = self.noise(out, noise)
        return self.activate(out)


class ToRGB(nn.Module):
    """1x1 non-demodulated modconv to RGB and the skip pyramid."""

    def __init__(self, in_ch: int, style_dim: int, upsample: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = ModulatedConv2d(in_ch, 3, 1, style_dim, demodulate=False,
                                    generator=generator)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))
        self.upsample = upsample

    def forward(self, x: torch.Tensor, style: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.conv(x, style) + self.bias
        if skip is not None:
            if self.upsample:
                skip = upsample2d(skip, BLUR_KERNEL)
            out = out + skip
        return out


def channel_table(channel_multiplier: int, channel_base: int = 512) -> Dict[int, int]:
    """Per-resolution channel widths (reference table, scaled by ``channel_base``)."""
    base = channel_base
    return {
        4: base, 8: base, 16: base, 32: base,
        64: base // 2 * channel_multiplier,
        128: base // 4 * channel_multiplier,
        256: base // 8 * channel_multiplier,
        512: base // 16 * channel_multiplier,
        1024: base // 32 * channel_multiplier,
    }


@dataclass(frozen=True)
class DecoderConfig:
    size: int = 256
    style_dim: int = 512  # 2x the renderer style_dim
    in_res: int = 64
    in_channels: int = 256
    channel_multiplier: int = 2
    channel_base: int = 512
    lr_mapping: float = 0.01
    n_mapping: int = 5

    @property
    def log_size(self) -> int:
        return int(math.log2(self.size))

    @property
    def log_in_size(self) -> int:
        return int(math.log2(self.in_res))

    @property
    def num_layers(self) -> int:
        return (self.log_size - self.log_in_size) * 2 + 1

    @property
    def n_latent(self) -> int:
        return (self.log_size - self.log_in_size) * 2 + 2

    @property
    def channels(self) -> Dict[int, int]:
        return channel_table(self.channel_multiplier, self.channel_base)

    def block_channels(self) -> List[Tuple[int, int]]:
        """(in, out) for each upsampling block."""
        chans = self.channels
        out, in_ch = [], chans[self.in_res]
        for i in range(self.log_in_size + 1, self.log_size + 1):
            out.append((in_ch, chans[2**i]))
            in_ch = chans[2**i]
        return out

    def noise_shapes(self) -> List[int]:
        """Spatial resolution of each per-layer noise buffer."""
        return [2 ** ((i + 2 * self.log_in_size + 1) // 2) for i in range(self.num_layers)]


class Decoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        sd = cfg.style_dim
        # style.0 is PixelNorm; EqualLinears at 1..n_mapping
        self.style = nn.Sequential(
            PixelNorm(),
            EqualLinear(sd // 2, sd, lr_mul=cfg.lr_mapping, activate=True, generator=generator),
            *[EqualLinear(sd, sd, lr_mul=cfg.lr_mapping, activate=True, generator=generator)
              for _ in range(cfg.n_mapping - 1)],
        )
        base_ch = cfg.channels[cfg.in_res]
        self.conv1 = StyledConv(cfg.in_channels, base_ch, 3, sd, generator=generator)
        self.to_rgb1 = ToRGB(base_ch, sd, upsample=False, generator=generator)
        self.convs = nn.ModuleList()
        self.to_rgbs = nn.ModuleList()
        for in_ch, out_ch in cfg.block_channels():
            self.convs.append(StyledConv(in_ch, out_ch, 3, sd, upsample=True, generator=generator))
            self.convs.append(StyledConv(out_ch, out_ch, 3, sd, generator=generator))
            self.to_rgbs.append(ToRGB(out_ch, sd, generator=generator))
        self.noises = nn.Module()
        for i, r in enumerate(cfg.noise_shapes()):
            self.noises.register_buffer(f"noise_{i}", normal((1, 1, r, r), generator))


def decoder_map_style(decoder: Decoder, z: torch.Tensor) -> torch.Tensor:
    """The decoder's PixelNorm + 5-layer mapping head."""
    return decoder.style(z)


def decoder_mean_latent(decoder: Decoder, renderer_latent: torch.Tensor) -> torch.Tensor:
    return torch.mean(decoder_map_style(decoder, renderer_latent), dim=0, keepdim=True)


def make_decoder_latent(
    decoder: Decoder,
    cfg: DecoderConfig,
    styles: Sequence[torch.Tensor],
    inject_index: Optional[int] = None,
    truncation: float = 1.0,
    truncation_latent: Optional[torch.Tensor] = None,
    input_is_latent: bool = False,
) -> torch.Tensor:
    """[B, n_latent, style_dim] per-layer latent with optional truncation
    and style mixing (layers < inject_index take style 0, the rest style 1)."""
    if not input_is_latent:
        styles = [decoder_map_style(decoder, s) for s in styles]
    if truncation < 1.0 and truncation_latent is not None:
        styles = [truncation_latent + truncation * (s - truncation_latent) for s in styles]
    n = cfg.n_latent
    if len(styles) < 2:
        s0 = styles[0]
        return s0[:, None, :].expand(-1, n, -1) if s0.ndim < 3 else s0
    idx = inject_index if inject_index is not None else n - 1
    layer = torch.arange(n, device=styles[0].device)[None, :, None]
    return torch.where(layer < idx, styles[0][:, None, :], styles[1][:, None, :])


def apply_decoder(
    decoder: Decoder,
    cfg: DecoderConfig,
    features: torch.Tensor,
    latent: torch.Tensor,
    rgbd_in: Optional[torch.Tensor] = None,
    noise: Optional[List[Optional[torch.Tensor]]] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Run the StyledConv/ToRGB pyramid.

    features: [B, in_res, in_res, in_channels] channel-last; latent from
    :func:`make_decoder_latent`; rgbd_in: optional channel-last skip input.
    noise: explicit per-layer [B or 1, 1, r, r] list (None entries: no
    noise); when None, random noise from ``generator`` if one is given,
    else the stored buffers.  Returns [B, size, size, 3] channel-last.
    """
    nlayers = cfg.num_layers
    noise_gen = None
    if noise is None:
        if generator is not None:
            noise, noise_gen = [None] * nlayers, generator
        else:
            noise = [getattr(decoder.noises, f"noise_{i}") for i in range(nlayers)]

    x = features.permute(0, 3, 1, 2).contiguous()
    skip_in = rgbd_in.permute(0, 3, 1, 2) if rgbd_in is not None else None
    out = decoder.conv1(x, latent[:, 0], noise[0], noise_gen)
    skip = decoder.to_rgb1(out, latent[:, 1], skip_in)
    i = 1
    for bi in range(len(decoder.to_rgbs)):
        out = decoder.convs[2 * bi](out, latent[:, i], noise[i], noise_gen)
        out = decoder.convs[2 * bi + 1](out, latent[:, i + 1], noise[i + 1], noise_gen)
        skip = decoder.to_rgbs[bi](out, latent[:, i + 2], skip)
        i += 2
    return skip.permute(0, 2, 3, 1)
