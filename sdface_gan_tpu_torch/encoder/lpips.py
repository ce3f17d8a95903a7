"""LPIPS perceptual loss (AlexNet features), port of
``sdface_gan_tpu/encoder/lpips.py:30-106``.

The scaling layer, then the five AlexNet convs with ReLU, 3x3/2 VALID max
pools after conv 0 and conv 1; each stage's features unit-normalised over
channels (``+1e-10`` inside the square root), squared differences weighted
by the 1x1 ``lin`` heads clamped at >= 0, averaged over batch and space,
summed over the stages.  Module names follow the archives
``import_lpips_state`` reads: ``alex.features.{0,3,6,8,10}`` (torchvision
AlexNet) and ``lins.lin{i}.model.1`` (LPIPS); :func:`load_lpips_archive`
loads a ``{"alex": ..., "lin": ...}`` archive.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ._layers import uniform_conv

# AlexNet feature stages: (out_ch, kernel, stride, pad), and the index of
# each conv in torchvision's ``features``
ALEX_STAGES = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1)]
ALEX_CONV_IDS = (0, 3, 6, 8, 10)
# ImageNet normalization applied from [-1, 1] inputs (LPIPS 'scaling layer')
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


@dataclass(frozen=True)
class LPIPSConfig:
    pass


class _LinHead(nn.Module):
    def __init__(self, ch: int, generator: torch.Generator):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   uniform_conv(ch, 1, 1, bias=False, generator=generator))


class LPIPS(nn.Module):
    """``forward(x, y)``: the perceptual distance between [B, H, W, 3] images
    in [-1, 1]; random init from ``generator`` (seed 0 when None)."""

    def __init__(self, cfg: LPIPSConfig = LPIPSConfig(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        convs, in_ch = {}, 3
        for cid, (out_ch, k, s, p) in zip(ALEX_CONV_IDS, ALEX_STAGES):
            convs[str(cid)] = uniform_conv(in_ch, out_ch, k, stride=s, padding=p,
                                           generator=generator)
            in_ch = out_ch
        self.alex = nn.Module()
        self.alex.features = nn.ModuleDict(convs)
        self.lins = nn.ModuleDict({f"lin{i}": _LinHead(st[0], generator)
                                   for i, st in enumerate(ALEX_STAGES)})
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        h = (x.permute(0, 3, 1, 2) - self.shift) / self.scale
        feats = []
        for i, cid in enumerate(ALEX_CONV_IDS):
            h = F.relu(self.alex.features[str(cid)](h))
            feats.append(h)
            if i in (0, 1):
                h = F.max_pool2d(h, 3, stride=2)
        return feats

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        total = x.new_zeros(())
        for i, (fx, fy) in enumerate(zip(self.features(x), self.features(y))):
            d = (_unit_norm(fx) - _unit_norm(fy)) ** 2
            w = torch.clamp(self.lins[f"lin{i}"].model[1].weight, min=0.0)  # non-negative lins
            total = total + torch.mean(F.conv2d(d, w))
        return total


def _unit_norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True) + 1e-10)


def load_lpips_archive(model: LPIPS, bundle: Dict[str, Dict[str, torch.Tensor]]) -> LPIPS:
    """Load torchvision AlexNet ``features.*`` (its classifier, if present, is
    left out) and LPIPS ``lin*.model.1.weight`` into ``model``, in place."""
    model.alex.load_state_dict({k: v for k, v in bundle["alex"].items()
                                if k.startswith("features.")})
    model.lins.load_state_dict(bundle["lin"])
    return model
