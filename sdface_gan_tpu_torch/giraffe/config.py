"""GIRAFFE model configs from the yaml tree, port of
``sdface_gan_tpu/giraffe/config.py``: the ``model.*_kwargs`` blocks as the
typed configs (the generator's and the DC discriminator's), with the
hash-encoding variants chosen by ``--i_embed`` / ``--small_net`` (and
their ``--finest_res`` / ``--log2_hashmap_size``).
The yaml's key spellings are the reference's (``check_collison``,
``backround_rotation_range``).
"""

from __future__ import annotations

from typing import Any, Optional

from .bbox import BBoxConfig
from .decoder import DecoderConfig, SmallDecoderConfig, giraffe_hash_spec
from .discriminator import DCDiscConfig
from .generator import GiraffeConfig
from .neural_renderer import NeuralRendererConfig


def add_giraffe_flags(p) -> None:
    """The flags that define a GIRAFFE model besides its yaml, read by
    :func:`giraffe_config_from_yaml`, on an ``argparse`` parser."""
    p.add_argument("--small_net", type=int, default=0)
    p.add_argument("--i_embed", type=int, default=0)
    p.add_argument("--finest_res", type=int, default=512)
    p.add_argument("--log2_hashmap_size", type=int, default=19)


def _tup(x, default):
    return default if x is None else tuple(x)


def giraffe_config_from_yaml(cfg: Any, args: Optional[Any] = None) -> GiraffeConfig:
    """The GiraffeConfig of a loaded yaml; ``args`` (the train / render
    flags) may set ``i_embed``, ``small_net``, ``finest_res`` and
    ``log2_hashmap_size``."""
    model = cfg.get("model", {})
    gen_kw = dict(model.get("generator_kwargs", {}))
    dec_kw = dict(model.get("decoder_kwargs", {}))
    bg_kw = dict(model.get("background_generator_kwargs", {}))
    bbox_kw = dict(model.get("bounding_box_generator_kwargs", {}))
    nr_kw = dict(model.get("neural_renderer_kwargs", {}))
    img_size = cfg.get("data", {}).get("img_size", 64)
    z_dim = model.get("z_dim", 256)
    z_dim_bg = model.get("z_dim_bg", 128)

    i_embed = getattr(args, "i_embed", 0)
    small_net = getattr(args, "small_net", 0)
    finest_res = getattr(args, "finest_res", 512)
    log2_hash = getattr(args, "log2_hashmap_size", 19)
    hash_spec = giraffe_hash_spec(finest_res, log2_hash) if i_embed == 1 else None

    decoder = DecoderConfig(
        z_dim=z_dim,
        rgb_out_dim=dec_kw.get("rgb_out_dim", 128),
        hidden_size=dec_kw.get("hidden_size", 128),
        n_blocks=dec_kw.get("n_blocks", 8),
        positional_encoding="hash" if i_embed == 1 else "normal",
        hash_spec=hash_spec,
    )
    small = SmallDecoderConfig(
        z_dim=z_dim,
        rgb_out_dim=dec_kw.get("rgb_out_dim", 128),
        hash_spec=hash_spec or giraffe_hash_spec(finest_res, log2_hash),
    )
    background = DecoderConfig(
        z_dim=z_dim_bg,
        hidden_size=bg_kw.get("hidden_size", 64),
        n_blocks=bg_kw.get("n_blocks", 4),
        skips=tuple(bg_kw.get("skips", [])),
        downscale_p_by=bg_kw.get("downscale_p_by", 12.0),
        rgb_out_dim=bg_kw.get("rgb_out_dim", 128),
    )
    bbox = BBoxConfig(
        n_boxes=bbox_kw.get("n_boxes", 1),
        scale_range_min=_tup(bbox_kw.get("scale_range_min"), (0.5, 0.5, 0.5)),
        scale_range_max=_tup(bbox_kw.get("scale_range_max"), (0.5, 0.5, 0.5)),
        translation_range_min=_tup(bbox_kw.get("translation_range_min"), (-0.75, -0.75, 0.0)),
        translation_range_max=_tup(bbox_kw.get("translation_range_max"), (0.75, 0.75, 0.0)),
        rotation_range=_tup(bbox_kw.get("rotation_range"), (0.0, 1.0)),
        check_collision=bbox_kw.get("check_collison", False),
        collision_padding=bbox_kw.get("collision_padding", 0.1),
        object_on_plane=bbox_kw.get("object_on_plane", False),
    )
    neural_renderer = NeuralRendererConfig(
        n_feat=nr_kw.get("n_feat", 128),
        input_dim=nr_kw.get("input_dim", 128),
        img_size=img_size,
    )
    return GiraffeConfig(
        z_dim=z_dim,
        z_dim_bg=z_dim_bg,
        range_u=_tup(gen_kw.get("range_u"), (0.0, 0.0)),
        range_v=_tup(gen_kw.get("range_v"), (0.25, 0.25)),
        range_radius=_tup(gen_kw.get("range_radius"), (2.732, 2.732)),
        depth_range=_tup(gen_kw.get("depth_range"), (0.5, 6.0)),
        n_ray_samples=gen_kw.get("n_ray_samples", 64),
        resolution_vol=gen_kw.get("resolution_vol", 16),
        fov=gen_kw.get("fov", 49.13),
        bg_rotation_range=_tup(gen_kw.get("backround_rotation_range"), (0.0, 0.0)),
        use_max_composition=gen_kw.get("use_max_composition", False),
        small_decoder=bool(small_net),
        decoder=decoder,
        small=small,
        background=background,
        bbox=bbox,
        neural_renderer=neural_renderer,
    )


def dc_disc_config_from_yaml(cfg: Any) -> DCDiscConfig:
    """The DC discriminator of a loaded yaml (``model.discriminator_kwargs``
    at ``data.img_size``)."""
    d_kw = dict(cfg.get("model", {}).get("discriminator_kwargs", {}))
    return DCDiscConfig(in_dim=d_kw.get("in_dim", 3), n_feat=d_kw.get("n_feat", 512),
                        img_size=cfg.get("data", {}).get("img_size", 64))
