"""The repository's configurations that the port runs, written out by hand.

The port reads no yaml.  Each generator function returns the
``GeneratorConfig`` that the JAX package's config path (``config/build.py``
``generator_config``, as ``train.py`` resolves a yaml file) gives for one
file of ``configs/`` and one stage; :func:`train_hparams` and
:func:`discriminator_configs` give the rest of the SDF training setup.
The tests hold each against that resolution.
"""

from __future__ import annotations

from typing import Tuple

from .models.discriminator import StyleDiscConfig, VolumeRenderDiscConfig
from .models.generator import GeneratorConfig
from .models.renderer import RendererConfig
from .training.steps import TrainHParams


def _ngp_256(**renderer) -> GeneratorConfig:
    return GeneratorConfig(
        size=256, style_dim=256, full_pipeline=True, freeze_renderer=True,
        channel_multiplier=2, channel_base=512, lr_mapping=0.01,
        renderer=RendererConfig(
            type="ngp", out_im_res=64, n_samples=24, style_dim=256, width=256, depth=8,
            force_background=False, output_features=True, **renderer),
    )


def ffhq_256_sdf_ngp_tpu() -> GeneratorConfig:
    """``configs/256res/ffhq_256_sdf_ngp_tpu.yaml``, stage B: the tuned grid,
    4 levels x 8 features, T = 2^15, finest resolution 256, packed tables at
    64 MB (levels 0 and 1 packed); its training settings are those of
    ``ffhq_256_sdf_tpu`` (4096 eikonal points, no remat)."""
    return _ngp_256(ngp_num_levels=4, ngp_level_dim=8, ngp_finest_res=256,
                    ngp_log2_hashmap_size=15, ngp_pack_mb=64, eikonal_subsample=4096,
                    remat=False)


def ffhq_256_sdf_ngp() -> GeneratorConfig:
    """``configs/256res/ffhq_256_sdf_ngp.yaml`` with ``--ngp 1``, stage B: the
    upstream grid, 16 levels x 2 features, T = 2^19, finest resolution 4096,
    no packing."""
    return _ngp_256(ngp_num_levels=16, ngp_level_dim=2, ngp_finest_res=4096,
                    ngp_log2_hashmap_size=19, ngp_pack_mb=0)


def _sdf_256(stage_a: bool, **training) -> GeneratorConfig:
    return GeneratorConfig(
        size=256, style_dim=256, full_pipeline=not stage_a, freeze_renderer=not stage_a,
        channel_multiplier=2, channel_base=512, lr_mapping=0.01,
        renderer=RendererConfig(
            type="sdf", out_im_res=64, n_samples=24, style_dim=256, width=256, depth=8,
            force_background=False, output_features=not stage_a, return_sdf=stage_a,
            **training),
    )


def ffhq_256_sdf(stage_a: bool) -> GeneratorConfig:
    """``configs/256res/ffhq_256_sdf.yaml``, the flagship, for stage A (the
    volume renderer: no feature output, the SDF returned for the minimal-
    surface term) or stage B (the full pipeline, renderer frozen).  The
    reference's settings: the eikonal term over every rendered point, the
    field rematerialized in the backward pass."""
    return _sdf_256(stage_a)


def ffhq_256_sdf_tpu(stage_a: bool) -> GeneratorConfig:
    """``configs/256res/ffhq_256_sdf_tpu.yaml``: the flagship with the eikonal
    term at 4096 fresh frustum points per image and no rematerialization
    (its bf16 parameters are ``train_hparams(tpu=True)``)."""
    return _sdf_256(stage_a, eikonal_subsample=4096, remat=False)


def train_hparams(tpu: bool = False, batch: int = 8) -> TrainHParams:
    """The SDF configurations' training hyperparameters: the defaults, and
    bf16 G parameters for the ``_tpu`` file."""
    return TrainHParams(batch=batch, g_param_dtype="bfloat16" if tpu else "float32")


def discriminator_configs(size: int = 256) -> Tuple[VolumeRenderDiscConfig, StyleDiscConfig]:
    """(stage-A D on 64^2 thumbs with the viewpoint head, stage-B D)."""
    return (VolumeRenderDiscConfig(in_res=64, viewpoint_head=True),
            StyleDiscConfig(size=size, channel_multiplier=2))
