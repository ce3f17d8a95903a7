"""Shared small layers, port of ``sdface_gan_tpu/models/layers.py``.

``ResnetBlockFC`` - the fully connected residual block of the
occupancy-style decoders (reference ``im2scene/layers.py:8-50``).  The conv
``ResnetBlock`` lives in :mod:`sdface_gan_tpu_torch.giraffe.discriminator`
and the blur in :mod:`sdface_gan_tpu_torch.giraffe.neural_renderer`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .init import uniform


class ResnetBlockFC(nn.Module):
    """``x -> shortcut(x) + fc_1(relu(fc_0(relu(x))))``, with ``fc_1``'s
    weight zero at init and a biasless ``shortcut`` only when ``size_in !=
    size_out`` (identity otherwise); ``size_h`` defaults to ``min(size_in,
    size_out)``.  The JAX package's distributions, drawn from
    ``generator`` (seed 0 when None): U(+-1/sqrt(size_in)) for ``fc_0`` and
    ``shortcut``, U(+-1/sqrt(size_h)) for ``fc_1``'s bias."""

    def __init__(self, size_in: int, size_out: Optional[int] = None,
                 size_h: Optional[int] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.size_in, self.size_h, self.size_out = size_in, size_h, size_out
        b0, bh = 1.0 / math.sqrt(size_in), 1.0 / math.sqrt(size_h)
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        self.shortcut = nn.Linear(size_in, size_out, bias=False) if size_in != size_out else None
        with torch.no_grad():
            self.fc_0.weight.copy_(uniform((size_h, size_in), b0, generator))
            self.fc_0.bias.copy_(uniform((size_h,), b0, generator))
            self.fc_1.weight.zero_()
            self.fc_1.bias.copy_(uniform((size_out,), bh, generator))
            if self.shortcut is not None:
                self.shortcut.weight.copy_(uniform((size_out, size_in), b0, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dx = self.fc_1(F.relu(self.fc_0(F.relu(x))))
        xs = self.shortcut(x) if self.shortcut is not None else x
        return xs + dx
