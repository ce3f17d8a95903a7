"""VAE encoder for latent inversion (``--vae 1``), port of
``sdface_gan_tpu/encoder/vae.py:26-87,134-141``.

Three stride-2 5x5 conv + BN + ReLU blocks, an fc (no bias) + BN1d + ReLU
trunk, and the mu / logvar heads.  The batch norms use the batch
statistics with the biased variance, in training and in the
reconstruction pass alike (``BatchStatNorm``), as the JAX ``_batch_norm``
does.  Images come channel-last [B, H, W, 3]; the convs run NCHW, so the
trunk flattens in (c, h, w) order where the JAX encoder flattens
(h, w, c): ``utils.convert.jax_vae_params_to_state_dict`` permutes the fc
weight's input axis to match.  (The VAE decoder is not on stage C's path
and is not ported.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ._layers import BatchStatNorm, uniform_conv, uniform_linear


@dataclass(frozen=True)
class VAEEncoderConfig:
    img_size: int = 64
    channel_in: int = 3
    z_size: int = 512

    @property
    def feat_channels(self):
        return [(self.channel_in, 64), (64, 128), (128, 256)]

    @property
    def fc_in(self) -> int:
        f = self.img_size // 8
        return f * f * 256


class _Block(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator):
        super().__init__()
        self.conv = uniform_conv(in_ch, out_ch, 5, stride=2, padding=2, bias=False,
                                 generator=generator)
        self.bn = BatchStatNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class VAEEncoder(nn.Module):
    """x [B, H, W, 3] -> (mu [B, z], logvar [B, z]); initialized from
    ``generator`` (seed 0 when None) with the JAX package's distributions."""

    def __init__(self, cfg: VAEEncoderConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.blocks = nn.ModuleList(_Block(ic, oc, generator) for ic, oc in cfg.feat_channels)
        self.fc = uniform_linear(cfg.fc_in, 1024, bias=False, generator=generator)
        self.fc_bn = BatchStatNorm(1024)
        self.l_mu = uniform_linear(1024, cfg.z_size, generator=generator)
        self.l_var = uniform_linear(1024, cfg.z_size, generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x.permute(0, 3, 1, 2)
        for block in self.blocks:
            h = block(h)
        h = F.relu(self.fc_bn(self.fc(h.flatten(1))))
        return self.l_mu(h), self.l_var(h)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """z = mu + eps * std (reference ``training_utils.py:1016-1017``); ``eps``
    is given, or drawn N(0, 1) from ``generator`` on ``mu``'s device."""
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
    return mu + torch.exp(0.5 * logvar) * eps


def kl_divergence(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    return -0.5 * torch.mean(torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=-1))
