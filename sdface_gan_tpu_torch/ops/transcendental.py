"""Polynomial sine and cosine, the FiLM-SIREN activation.

Port of ``sdface_gan_tpu/ops/transcendental.py``: wrap the argument to
[-pi, pi] with a round-based f32 reduction, then evaluate a degree-11 odd
minimax polynomial (max abs error 9.6e-8 on the reduced range).  The
reduction always runs in f32: in bf16, ``round(x / 2pi) * 2pi`` keeps only
8 mantissa bits and is useless for |x| >> 1.  ``torch.round`` rounds half
to even, as ``jnp.round`` does.  The CUDA field kernel carries the same
function as a device function (``csrc/siren_field.cu``).
"""

from __future__ import annotations

import torch

TWO_PI = 6.283185307179586
INV_TWO_PI = 0.15915494309189535

# Odd minimax coefficients for sin on [-pi, pi].
S1 = 9.9999959990e-01
S3 = -1.6666552631e-01
S5 = 8.3324029612e-03
S7 = -1.9808632624e-04
S9 = 2.6997138288e-06
S11 = -2.0362212148e-08


def fast_sin(x: torch.Tensor) -> torch.Tensor:
    """sin(x) via wrap-to-[-pi, pi] and a degree-11 odd polynomial."""
    dtype = x.dtype
    x = x.float()
    x = x - torch.round(x * INV_TWO_PI) * TWO_PI
    x2 = x * x
    p = S11 * x2 + S9
    p = p * x2 + S7
    p = p * x2 + S5
    p = p * x2 + S3
    p = p * x2 + S1
    return (x * p).to(dtype)


def fast_cos(x: torch.Tensor) -> torch.Tensor:
    """cos(x) = sin(x + pi/2) through the same path."""
    return fast_sin(x + 1.5707963267948966)
