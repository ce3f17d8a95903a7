"""ArcFace identity loss, port of ``sdface_gan_tpu/encoder/id_loss.py:16-30``.

Crop the face region (rows 35:223, cols 32:220 of a 256^2 image), resize
it to 112^2, embed it with the ir_se-50 backbone, L2-normalise, and
penalise ``1 - cos(feat(gen), feat(real))`` with the real side detached.
The resize is ``jax.image.resize(method="bilinear")``: half-pixel centres,
antialiased when it shrinks (188 -> 112 here), the rule the port's FID
Inception follows too (``evaluation/inception.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .irse import IRSEBackbone

CROP_ROWS, CROP_COLS = slice(35, 223), slice(32, 220)
ID_SIZE = 112


def extract_face_features(backbone: IRSEBackbone, imgs: torch.Tensor) -> torch.Tensor:
    """imgs [B, 256, 256, 3] in [-1, 1] -> unit-norm embeddings [B, 512]
    (reference ``id_loss.py:14-22``)."""
    crop = imgs[:, CROP_ROWS, CROP_COLS, :].permute(0, 3, 1, 2)
    shrink = crop.shape[-2] > ID_SIZE or crop.shape[-1] > ID_SIZE
    pooled = F.interpolate(crop, size=(ID_SIZE, ID_SIZE), mode="bilinear",
                           align_corners=False, antialias=shrink)
    feats = backbone.embed(pooled)
    return feats / torch.linalg.norm(feats, dim=-1, keepdim=True)


def id_loss(backbone: IRSEBackbone, generated: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """``mean(1 - <feat(gen), feat(real)>)`` (reference ``id_loss.py:24-43``)."""
    f_gen = extract_face_features(backbone, generated)
    f_real = extract_face_features(backbone, real).detach()
    return torch.mean(1.0 - torch.sum(f_gen * f_real, dim=-1))
