"""The port's config layer, counterpart of ``sdface_gan_tpu/config``: yaml
files with ``inherit_from`` -> option tree -> the port's dataclasses
(``build.py``, which imports the models)."""

from .node import ConfigNode
from .yaml_config import load_config, save_config
from .sdf_options import sdf_defaults, parse_sdf_options, get_vol_render_opt

__all__ = [
    "ConfigNode",
    "load_config",
    "save_config",
    "sdf_defaults",
    "parse_sdf_options",
    "get_vol_render_opt",
]
