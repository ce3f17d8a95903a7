"""Stage optimizers, port of ``sdface_gan_tpu/training/optim.py`` (the SDF
stages).

* Stage A (volume renderer): Adam, G lr 2e-5 / D lr 2e-4, betas (0, 0.9).
* Stage B (full pipeline): StyleGAN2's lazy-regularization Adam, lr and
  betas scaled by ``reg_every / (reg_every + 1)`` (``b1 = 0.0 ** ratio``),
  with the G optimizer over the ``decoder.*`` parameters only: the JAX
  package's optax mask trains the ``decoder`` subtree and leaves
  ``mapping`` (here ``style.*``) and ``renderer`` frozen.

``torch.optim.Adam`` with ``eps=1e-8`` is optax's ``adam`` (``eps_root=0``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn


def _adam(params, lr: float, b1: float, b2: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8)


def _reg_ratio(reg_every: int) -> float:
    return reg_every / (reg_every + 1) if reg_every > 0 else 1.0


def stage_a_optimizers(
    g: nn.Module, d: nn.Module, d_reg_every: int = 1
) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    """(G, D) optimizers for the volume-renderer stage.  ``d_reg_every`` is
    the stage-A lazy-R1 interval: above 1 the D's lr and betas take the
    same ratio adjustment as in stage B."""
    d_ratio = _reg_ratio(d_reg_every) if d_reg_every > 1 else 1.0
    return (_adam(g.parameters(), 2e-5, 0.0, 0.9),
            _adam(d.parameters(), 2e-4 * d_ratio, 0.0**d_ratio, 0.9**d_ratio))


def decoder_only(g: nn.Module) -> List[nn.Parameter]:
    """The generator's ``decoder.*`` parameters, the only ones stage B trains."""
    return [p for name, p in g.named_parameters() if name.startswith("decoder.")]


def stage_b_optimizers(
    g: nn.Module, d: nn.Module, lr: float = 2e-3, g_reg_every: int = 4,
    d_reg_every: int = 16,
) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    """(G over :func:`decoder_only`, D) optimizers for the StyleGAN stage."""
    g_ratio, d_ratio = _reg_ratio(g_reg_every), _reg_ratio(d_reg_every)
    return (_adam(decoder_only(g), lr * g_ratio, 0.0**g_ratio, 0.99**g_ratio),
            _adam(d.parameters(), lr * d_ratio, 0.0**d_ratio, 0.99**d_ratio))
