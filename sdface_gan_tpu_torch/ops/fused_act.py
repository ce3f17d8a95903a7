"""Bias + leaky-ReLU, port of ``sdface_gan_tpu/ops/fused_act.py``.

``out = scale * leaky_relu(x + bias)``.  The port keeps PyTorch's
channel-first layout, so the bias broadcasts on axis 1 ([B, C] or
[B, C, H, W]); the JAX op broadcasts on the last axis.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu(
    x: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    negative_slope: float = 0.2,
    scale: float = SQRT2,
) -> torch.Tensor:
    """``scale * leaky_relu(x + bias)`` with bias broadcast on axis 1.

    The two constants are rounded to ``x``'s dtype first, as JAX's weak
    typing rounds a Python scalar (in bf16 the slope is 0.2001953125)."""
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.ndim - 2))
    slope, scale = in_dtype(negative_slope, x.dtype), in_dtype(scale, x.dtype)
    return scale * torch.where(x >= 0, x, slope * x)


@functools.lru_cache(maxsize=None)
def in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (a float dtype), as a Python float."""
    return torch.tensor(value, dtype=dtype).item()
