"""Exponential moving average of the generator's parameters, port of
``sdface_gan_tpu/training/ema.py``: ``ema = decay * ema + (1 - decay) * p``
with the reference decay ``0.5 ** (32 / 10000) ~= 0.99778``."""

from __future__ import annotations

import torch
from torch import nn

EMA_DECAY = 0.5 ** (32.0 / 10000.0)


@torch.no_grad()
def accumulate(ema: nn.Module, model: nn.Module, decay: float = EMA_DECAY) -> None:
    """Fold ``model``'s parameters into ``ema``'s, in place."""
    for e, p in zip(ema.parameters(), model.parameters()):
        e.mul_(decay).add_(p, alpha=1.0 - decay)
