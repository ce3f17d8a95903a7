"""upfirdn2d — upsample, FIR filter, downsample (StyleGAN2 resampling).

Port of ``sdface_gan_tpu/ops/upfirdn2d.py`` in PyTorch's NCHW layout:
zero-stuff by ``up`` (with ``up - 1`` zeros after every sample, the last
one included, as the reference does), pad (negative pads crop), correlate
with the flipped kernel as one depthwise ``conv2d``, stride by ``down``.

Output size per spatial dim: ``(in * up + pad0 + pad1 - kernel) // down + 1``.

The filter is linear in ``x`` and its adjoint is the same filter with the
kernel flipped, ``up`` and ``down`` swapped and the pads adjusted (the
reference CUDA op's backward).  :func:`upfirdn2d` is an autograd function
built on that, whose backward is itself, so every derivative order runs as
one depthwise ``conv2d``.  PyTorch's own double backward of a grouped conv
runs one small convolution per channel, which on an H100 took most of a
stage-B R1 step at 256^2.
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


def _upfirdn2d(
    x: torch.Tensor, kernel: torch.Tensor, up: int, down: int, pad: Tuple[int, int]
) -> torch.Tensor:
    b, c, h, w = x.shape
    if up > 1:
        x = x.reshape(b, c, h, 1, w, 1)
        x = F.pad(x, (0, up - 1, 0, 0, 0, up - 1))
        x = x.reshape(b, c, h * up, w * up)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    kh, kw = kernel.shape
    k = torch.flip(kernel, (0, 1)).to(device=x.device, dtype=x.dtype)
    return F.conv2d(x, k.expand(c, 1, kh, kw), stride=down, groups=c)


class _UpFirDn2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, up, down, pad):
        ctx.save_for_backward(kernel)
        ctx.geometry = (up, down, pad, x.shape[-1])
        return _upfirdn2d(x, kernel, up, down, pad)

    @staticmethod
    def backward(ctx, grad):
        (kernel,) = ctx.saved_tensors
        up, down, (pad0, _), size = ctx.geometry
        k = kernel.shape[0]
        g_pad = (k - pad0 - 1, size * up - grad.shape[-1] * down + pad0 - up + 1)
        return (_UpFirDn2d.apply(grad, torch.flip(kernel, (0, 1)), down, up, g_pad),
                None, None, None, None)


def upfirdn2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    up: int = 1,
    down: int = 1,
    pad: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """Apply up/FIR/down resampling to ``x`` [B, C, H, W] (square kernel,
    equal H and W factors and pads).  ``kernel`` is a constant: no gradient
    reaches it."""
    if x.ndim != 4:
        raise ValueError(f"upfirdn2d expects a rank-4 tensor, got {tuple(x.shape)}")
    return _UpFirDn2d.apply(x, kernel.detach(), up, down, tuple(pad))


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
