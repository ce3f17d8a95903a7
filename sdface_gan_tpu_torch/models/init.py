"""Parameter initializers, port of ``sdface_gan_tpu/models/init.py``.

Same distributions as the JAX package, drawn from an explicit
``torch.Generator``.  Weights use PyTorch's ``[out, in]`` layout, so the
fan-in is ``shape[1]`` (the JAX package stores ``[in, out]``).  Draws run
on the CPU generator given; the modules move to their device afterwards,
so a seed gives the same weights on every device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch


def uniform(
    shape: Sequence[int], bound: float, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """U(-bound, bound) in f32."""
    return torch.empty(tuple(shape)).uniform_(-bound, bound, generator=generator)


def normal(
    shape: Sequence[int], generator: Optional[torch.Generator]
) -> torch.Tensor:
    """N(0, 1) in f32."""
    return torch.randn(tuple(shape), generator=generator)


def kaiming_leaky(
    shape: Sequence[int],
    generator: Optional[torch.Generator],
    a: float = 0.2,
    gain_mul: float = 1.0,
) -> torch.Tensor:
    """torch ``kaiming_normal_(a, fan_in, leaky_relu)`` for an [out, in] weight."""
    fan_in = shape[1]
    gain = math.sqrt(2.0 / (1.0 + a * a))
    std = gain / math.sqrt(fan_in) * gain_mul
    return std * normal(shape, generator)


def linear_params(
    in_dim: int,
    out_dim: int,
    generator: Optional[torch.Generator],
    mode: str = "kaiming",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SIREN-family LinearLayer (weight [out, in], bias [out]).

    mode: 'freq'    -> W ~ U(-sqrt(6/in)/25, sqrt(6/in)/25)
          'kaiming' -> 0.25 * kaiming_normal(a=0.2)
          'torch'   -> W ~ U(-1/sqrt(in), 1/sqrt(in)) (torch ``nn.Linear``)
    Bias is always U(-sqrt(1/in), sqrt(1/in)).
    """
    shape = (out_dim, in_dim)
    if mode == "freq":
        w = uniform(shape, math.sqrt(6.0 / in_dim) / 25.0, generator)
    elif mode == "torch":
        w = uniform(shape, 1.0 / math.sqrt(in_dim), generator)
    elif mode == "kaiming":
        w = kaiming_leaky(shape, generator, gain_mul=0.25)
    else:
        raise ValueError(mode)
    return w, uniform((out_dim,), math.sqrt(1.0 / in_dim), generator)


def film_siren_weight(
    in_dim: int, out_dim: int, is_first: bool, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """FiLMSiren weight [out, in]."""
    bound = 1.0 / 3.0 if is_first else math.sqrt(6.0 / in_dim) / 25.0
    return uniform((out_dim, in_dim), bound, generator)


def hash_table(
    rows: int, level_dim: int, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Hash-grid embedding table [rows, level_dim] ~ U(-1e-4, 1e-4)."""
    return uniform((rows, level_dim), 1e-4, generator)


def mapping_linear_params(
    in_dim: int,
    out_dim: int,
    generator: Optional[torch.Generator],
    is_last: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MappingLinear (weight [out, in], bias [out])."""
    std = 0.25 if is_last else 1.0
    w = kaiming_leaky((out_dim, in_dim), generator, gain_mul=std)
    return w, uniform((out_dim,), math.sqrt(1.0 / in_dim), generator)
