"""Inversion loss bundle, port of ``sdface_gan_tpu/encoder/losses.py:20-63``.

The weighted sum of the ArcFace identity loss (0.1), pixel L2 (1.0) and
LPIPS (0.8) (reference ``LossUtils``, ``psp_encoders.py:195-228``).  A term
is off when its net is ``None``, so stage C trains on L2 alone without
pretrained perceptual weights.  The nets are frozen: no parameter of
theirs takes a gradient, which still flows through them to the images.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .id_loss import id_loss
from .irse import IRSEBackbone
from .lpips import LPIPS

ID_LAMBDA, L2_LAMBDA, LPIPS_LAMBDA = 0.1, 1.0, 0.8


class LossUtils:
    def __init__(self, irse: Optional[IRSEBackbone] = None, lpips: Optional[LPIPS] = None):
        for net in (irse, lpips):
            if net is not None:
                net.requires_grad_(False)
        self.irse = irse
        self.lpips = lpips

    def __call__(self, generated: torch.Tensor, real: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        l2 = torch.mean((generated - real) ** 2)
        out["l2"] = l2
        total = L2_LAMBDA * l2
        if self.irse is not None:
            out["id"] = id_loss(self.irse, generated, real)
            total = total + ID_LAMBDA * out["id"]
        if self.lpips is not None:
            out["lpips"] = self.lpips(generated, real)
            total = total + LPIPS_LAMBDA * out["lpips"]
        out["loss"] = total
        return out
