"""YAML config loading with recursive ``inherit_from``, port of
``sdface_gan_tpu/config/yaml_config.py`` (``load_config``,
``default_config_path``, ``save_config``) over the port's own reader of
the YAML subset that ``configs/`` uses (``yaml_subset.py``).

A config may name a parent via ``inherit_from``; otherwise
``default_path`` seeds the tree; the file's own entries are merged on top
recursively.
"""

from __future__ import annotations

import os
from typing import Optional

from .node import ConfigNode
from .yaml_subset import safe_dump, safe_load

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _read(path: str):
    with open(path, "r") as f:
        return safe_load(f.read())


def load_config(path: str, default_path: Optional[str] = None) -> ConfigNode:
    """Load a YAML config file, resolving ``inherit_from`` chains
    (:func:`parent_path`)."""
    cfg_special = _read(path) or {}

    parent = parent_path(path, cfg_special)
    if parent is not None:
        cfg = load_config(parent, default_path)
    elif default_path is not None:
        cfg = ConfigNode(_read(default_path) or {})
    else:
        cfg = ConfigNode()

    if not isinstance(cfg, ConfigNode):
        cfg = ConfigNode(cfg)
    cfg.update_recursive(cfg_special)
    return cfg


def parent_path(path: str, entries: Optional[dict] = None) -> Optional[str]:
    """The file that ``path`` names in ``inherit_from`` (None when it names
    none), resolved against the current directory first, then against the
    config file's own directory (the JAX package's order), then against
    the repository root.  ``entries``: the file's own entries, when read."""
    parent = (entries if entries is not None else _read(path) or {}).get("inherit_from")
    if parent is not None and not os.path.isabs(parent) and not os.path.exists(parent):
        for base in (os.path.dirname(path), REPO_ROOT):
            if os.path.exists(os.path.join(base, parent)):
                return os.path.join(base, parent)
    return parent


def default_config_path() -> str:
    """Path to the repository's ``configs/default.yaml`` (the base every
    config inherits)."""
    return os.path.join(REPO_ROOT, "configs", "default.yaml")


def save_config(cfg: ConfigNode, path: str) -> None:
    with open(path, "w") as f:
        f.write(safe_dump(cfg.to_dict()))
