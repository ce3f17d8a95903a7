"""Checkpoints of the SDF stages in the port's own ``torch.save`` format.

The names follow ``sdface_gan_tpu/utils/checkpoints.py``: periodic
``models_{step:07d}`` and the stage artifacts ``sdf_init_models``,
``vol_renderer`` and ``full_pipeline``, each one file ``<name>.pt`` under
the stage's directory holding a dict of state dicts and scalars.  A save
writes a temporary file and renames it, so a cut run never leaves half a
checkpoint.  (The JAX package's orbax checkpoints are not read here.)
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
