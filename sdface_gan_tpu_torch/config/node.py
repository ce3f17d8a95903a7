"""Attribute-access config tree, the port's copy of
``sdface_gan_tpu/config/node.py``: one small recursive attr-dict with
explicit copy/merge semantics, so per-stage configs are copies rather than
mid-run mutations.
"""

from __future__ import annotations

import copy
from typing import Any, Iterator, Mapping


class ConfigNode(dict):
    """A dict with attribute access and recursive conversion.

    ``node.a.b = 1`` works; nested dicts auto-wrap into ConfigNodes.
    """

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__()
        for src in list(args) + [kwargs]:
            if src is None:
                continue
            if not isinstance(src, Mapping):
                raise TypeError(f"ConfigNode expects mappings, got {type(src)}")
            for k, v in src.items():
                self[k] = v

    # -- item/attr plumbing -------------------------------------------------
    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, ConfigNode):
            value = ConfigNode(value)
        super().__setitem__(key, value)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    # -- utilities ----------------------------------------------------------
    def copy(self) -> "ConfigNode":
        return copy.deepcopy(self)

    def merged_with(self, other: Mapping | None) -> "ConfigNode":
        """Return a new node: self recursively updated with ``other``.

        Mirrors the reference's ``update_recursive`` (``config.py:54-68``):
        dict values merge recursively, scalars/lists overwrite.
        """
        out = self.copy()
        out.update_recursive(other or {})
        return out

    def update_recursive(self, other: Mapping) -> None:
        for k, v in other.items():
            if isinstance(v, Mapping) and isinstance(self.get(k), Mapping):
                node = self[k]
                if not isinstance(node, ConfigNode):
                    node = ConfigNode(node)
                    self[k] = node
                node.update_recursive(v)
            else:
                self[k] = v

    def flat_items(self, prefix: str = "") -> Iterator[tuple[str, Any]]:
        for k, v in self.items():
            path = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, ConfigNode):
                yield from v.flat_items(path)
            else:
                yield path, v

    def to_dict(self) -> dict:
        return {
            k: (v.to_dict() if isinstance(v, ConfigNode) else v)
            for k, v in self.items()
        }
