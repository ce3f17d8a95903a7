"""Checkpoints of the SDF stages in the port's own ``torch.save`` format.

The names follow ``sdface_gan_tpu/utils/checkpoints.py``: periodic
``models_{step:07d}`` and the stage artifacts ``sdf_init_models``,
``vol_renderer``, ``full_pipeline`` and stage C's ``encoder``, each one file
``<name>.pt`` under the stage's directory holding a dict of state dicts and
scalars (stage C's ``models_*``: ``{e, e_opt, step}``, the optimizer's
state dict carrying Ranger's slow weights and step count).  A save
writes a temporary file and renames it, so a cut run never leaves half a
checkpoint.  ``load_generator`` builds a stored generator for the eval and
geometry entries.  (The JAX package's orbax checkpoints are not read here.)
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional, Union

import torch


def _path(base_dir: str, name: str) -> str:
    return os.path.abspath(os.path.join(base_dir, f"{name}.pt"))


def save_checkpoint(base_dir: str, name: str, tree: Dict[str, Any]) -> str:
    """Save ``tree`` (state dicts, tensors, numbers) as ``<name>.pt``, replacing it."""
    os.makedirs(base_dir, exist_ok=True)
    path = _path(base_dir, name)
    torch.save(tree, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def load_checkpoint(base_dir: str, name: str,
                    map_location: Optional[Union[str, torch.device]] = None) -> Dict[str, Any]:
    """Load ``<name>.pt`` (tensors only: ``weights_only``)."""
    return torch.load(_path(base_dir, name), map_location=map_location, weights_only=True)


def checkpoint_exists(base_dir: str, name: str) -> bool:
    return os.path.isfile(_path(base_dir, name))


def latest_checkpoint_step(base_dir: str, prefix: str = "models_") -> Optional[int]:
    """The newest ``<prefix>{step}`` checkpoint's step, or None."""
    if not os.path.isdir(base_dir):
        return None
    pat = re.compile(rf"^{re.escape(prefix)}(\d+)\.pt$")
    steps = [int(m.group(1)) for m in map(pat.match, os.listdir(base_dir)) if m]
    return max(steps) if steps else None


def load_generator(base_dir: str, name: str, cfg, which: str = "g_ema",
                   device: Union[str, torch.device] = "cuda"):
    """The generator ``which`` (``g`` or ``g_ema``) of checkpoint ``<name>.pt``,
    built for ``cfg`` (a ``GeneratorConfig``) on ``device``, in eval mode.
    Tensors of a stored dtype (bf16 training) load into the f32 model."""
    from ..models.generator import Generator

    model = Generator(cfg, device=device)
    model.load_state_dict(load_checkpoint(base_dir, name, map_location=device)[which])
    return model.eval()
