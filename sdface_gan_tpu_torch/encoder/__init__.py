"""Inversion encoders and perceptual losses, port of
``sdface_gan_tpu/encoder/``: the VAE encoder of ``--vae``, the pSp
GradualStyleEncoder on an ir_se-50 FPN of ``--psp``, the ArcFace identity
loss and LPIPS.  Pretrained torch weights (``model_ir_se50.pth``, LPIPS
Alex) load with ``load_state_dict`` / ``load_lpips_archive``; the nets run
on random weights regardless.  The JAX package's ``init_*`` / ``apply_*``
pairs are modules here (``VAEEncoder``, ``VAEDecoder``, ``IRSEBackbone``,
``LPIPS``, ...)."""

from .id_loss import extract_face_features, id_loss
from .irse import GradualStyleEncoder, IRSEBackbone, IRSEConfig
from .losses import LossUtils
from .lpips import LPIPS, LPIPSConfig, load_lpips_archive
from .psp import PSPConfig, PSPEncoder
from .vae import (
    VAEDecoder,
    VAEDecoderConfig,
    VAEEncoder,
    VAEEncoderConfig,
    kl_divergence,
    reparameterize,
)

__all__ = [
    "VAEEncoderConfig",
    "VAEEncoder",
    "VAEDecoderConfig",
    "VAEDecoder",
    "reparameterize",
    "kl_divergence",
    "IRSEConfig",
    "IRSEBackbone",
    "GradualStyleEncoder",
    "extract_face_features",
    "id_loss",
    "LPIPSConfig",
    "LPIPS",
    "load_lpips_archive",
    "LossUtils",
    "PSPConfig",
    "PSPEncoder",
]
