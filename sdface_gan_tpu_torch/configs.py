"""The repository's NGP serving configurations, written out by hand.

The port reads no yaml.  Each function returns the ``GeneratorConfig`` that
the JAX package's config path (``config/build.py`` ``generator_config``,
stage B, as ``train.py`` resolves a yaml file) gives for one file of
``configs/``, restricted to the fields the port has (training-only fields
such as ``remat`` and ``eikonal_subsample`` are not part of it).  The
tests hold each against that resolution.
"""

from __future__ import annotations

from .models.generator import GeneratorConfig
from .models.renderer import RendererConfig


def _ngp_256(**grid) -> GeneratorConfig:
    return GeneratorConfig(
        size=256, style_dim=256, full_pipeline=True, channel_multiplier=2,
        channel_base=512, lr_mapping=0.01,
        renderer=RendererConfig(
            type="ngp", out_im_res=64, n_samples=24, style_dim=256, width=256, depth=8,
            force_background=False, output_features=True, **grid),
    )


def ffhq_256_sdf_ngp_tpu() -> GeneratorConfig:
    """``configs/256res/ffhq_256_sdf_ngp_tpu.yaml``: the tuned grid, 4 levels
    x 8 features, T = 2^15, finest resolution 256, packed tables at 64 MB
    (levels 0 and 1 packed)."""
    return _ngp_256(ngp_num_levels=4, ngp_level_dim=8, ngp_finest_res=256,
                    ngp_log2_hashmap_size=15, ngp_pack_mb=64)


def ffhq_256_sdf_ngp() -> GeneratorConfig:
    """``configs/256res/ffhq_256_sdf_ngp.yaml`` with ``--ngp 1``: the upstream
    grid, 16 levels x 2 features, T = 2^19, finest resolution 4096, no
    packing."""
    return _ngp_256(ngp_num_levels=16, ngp_level_dim=2, ngp_finest_res=4096,
                    ngp_log2_hashmap_size=19, ngp_pack_mb=0)
