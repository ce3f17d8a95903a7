"""upfirdn2d — upsample, FIR filter, downsample (StyleGAN2 resampling).

Port of ``sdface_gan_tpu/ops/upfirdn2d.py`` in PyTorch's NCHW layout:
zero-stuff by ``up`` (with ``up - 1`` zeros after every sample, the last
one included, as the reference does), pad (negative pads crop), correlate
with the flipped kernel as one depthwise ``conv2d``, stride by ``down``.

Output size per spatial dim: ``(in * up + pad0 + pad1 - kernel) // down + 1``.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F


def make_kernel(
    k: Union[Sequence[float], torch.Tensor], device=None
) -> torch.Tensor:
    """Normalized 2D FIR kernel (f32) from a 1D or 2D tap list."""
    k = torch.as_tensor(k, dtype=torch.float32, device=device)
    if k.ndim == 1:
        k = k[None, :] * k[:, None]
    return k / torch.sum(k)


def upfirdn2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    up: int = 1,
    down: int = 1,
    pad: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """Apply up/FIR/down resampling to ``x`` [B, C, H, W]."""
    if x.ndim != 4:
        raise ValueError(f"upfirdn2d expects a rank-4 tensor, got {tuple(x.shape)}")
    b, c, h, w = x.shape
    if up > 1:
        x = x.reshape(b, c, h, 1, w, 1)
        x = F.pad(x, (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(b, c, h * up, w * up)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    kh, kw = kernel.shape
    k = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    return F.conv2d(x, k.expand(c, 1, kh, kw), stride=down, groups=c)


def upsample2d(
    x: torch.Tensor, kernel: Union[Sequence[float], torch.Tensor], factor: int = 2
) -> torch.Tensor:
    """Blur-upsample (reference ``Upsample``)."""
    k = make_kernel(kernel, x.device) * (factor**2)
    p = k.shape[0] - factor
    pad0 = (p + 1) // 2 + factor - 1
    pad1 = p // 2
    return upfirdn2d(x, k, up=factor, down=1, pad=(pad0, pad1))


def blur(
    x: torch.Tensor,
    kernel: Union[Sequence[float], torch.Tensor],
    pad: Tuple[int, int],
    upsample_factor: int = 1,
) -> torch.Tensor:
    """FIR blur with explicit padding (reference ``Blur``)."""
    k = make_kernel(kernel, x.device)
    if upsample_factor > 1:
        k = k * (upsample_factor**2)
    return upfirdn2d(x, k, pad=pad)
