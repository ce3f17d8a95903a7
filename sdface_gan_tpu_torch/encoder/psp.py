"""pSp inversion encoder: GradualStyleEncoder + renderer-style projection,
port of ``sdface_gan_tpu/encoder/psp.py:38-82``.

The W+ stack [B, style_count, 512] drives the StyleGAN decoder
(``style_count`` == the decoder's ``n_latent``), and a learned projection
``proj`` of the first W+ entry gives the renderer's ``style_dim`` latent
(the JAX package's completion of the reference's commented pSp path,
whose renderer slice of a 512-d style cannot run).  With
``start_from_avg`` the encoder predicts offsets from the generator's mean
styles.  A ``model_ir_se50.pth`` warm-starts ``gse.backbone`` with
``load_state_dict``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ._layers import uniform_linear
from .irse import GradualStyleEncoder, IRSEConfig


@dataclass(frozen=True)
class PSPConfig:
    img_size: int = 256
    style_count: int = 6          # == decoder n_latent for 256^2 / 64-res in
    renderer_style_dim: int = 256
    # pSp's start_from_latent_avg: offsets from the generator's mean styles
    # (renderer W mean, decoder W mean) instead of absolute latents
    start_from_avg: bool = True

    @property
    def irse(self) -> IRSEConfig:
        # the FPN split points clamped to style_count: an equal-resolution
        # decoder (renderer out_im_res == img_size) has n_latent == 2
        return IRSEConfig(
            psp_input_size=self.img_size,
            style_count=self.style_count,
            coarse_ind=min(IRSEConfig.coarse_ind, self.style_count),
            middle_ind=min(IRSEConfig.middle_ind, self.style_count),
        )


class PSPEncoder(nn.Module):
    """x [B, S, S, 3] in [-1, 1] -> (renderer latent [B, style_dim], W+ stack
    [B, style_count, 512]); initialized from ``generator`` (seed 0 when
    None) with the JAX package's distributions."""

    def __init__(self, cfg: PSPConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg = cfg
        self.gse = GradualStyleEncoder(cfg.irse, generator)
        self.proj = uniform_linear(512, cfg.renderer_style_dim, generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        wplus = self.gse(x)
        return self.proj(wplus[:, 0]), wplus
