"""The repository's 256^2 SDF configurations as the port's dataclasses.

Each function loads its file of ``configs/256res/`` and resolves it for one
stage through ``config.build``, as ``python -m sdface_gan_tpu_torch.train``
does (``--batch`` 8 unless given).  The tests hold each against the JAX
package's resolution of the same file.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

from .config import build
from .config.node import ConfigNode
from .config.yaml_config import REPO_ROOT, default_config_path, load_config
from .models.discriminator import StyleDiscConfig, VolumeRenderDiscConfig
from .models.generator import GeneratorConfig
from .training.steps import TrainHParams


def _options(name: str, stage_a: bool, ngp: bool = False, batch: int = 8) -> ConfigNode:
    path = os.path.join(REPO_ROOT, "configs", "256res", f"{name}.yaml")
    cfg = load_config(path, default_config_path())
    return build.stage_options(cfg, stage_a, ngp=ngp, batch=batch)


def ffhq_256_sdf_ngp_tpu(stage_a: bool = False) -> GeneratorConfig:
    """``ffhq_256_sdf_ngp_tpu.yaml``, stage B (or A): the tuned grid, 4
    levels x 8 features, T = 2^15, finest resolution 256, packed tables at
    64 MB (inference); 4096 eikonal points, no remat (its bf16 G parameters
    are ``train_hparams(tpu=True, ngp=True)``)."""
    return build.generator_config(_options("ffhq_256_sdf_ngp_tpu", stage_a), stage_a=stage_a)


def ffhq_256_sdf_ngp(stage_a: bool = False) -> GeneratorConfig:
    """``ffhq_256_sdf_ngp.yaml`` with ``--ngp 1``, stage B (or A): the
    upstream grid, 16 levels x 2 features, T = 2^19, finest resolution
    4096; the eikonal term over every rendered point, remat."""
    return build.generator_config(_options("ffhq_256_sdf_ngp", stage_a, ngp=True),
                                  stage_a=stage_a)


def ffhq_256_sdf(stage_a: bool) -> GeneratorConfig:
    """``ffhq_256_sdf.yaml``, the flagship, for stage A (the volume
    renderer) or stage B (the full pipeline, renderer frozen): the eikonal
    term over every rendered point, the field rematerialized."""
    return build.generator_config(_options("ffhq_256_sdf", stage_a), stage_a=stage_a)


def ffhq_256_sdf_tpu(stage_a: bool) -> GeneratorConfig:
    """``ffhq_256_sdf_tpu.yaml``: the flagship with the eikonal term at 4096
    fresh frustum points per image and no remat (its bf16 G parameters are
    ``train_hparams(tpu=True)``)."""
    return build.generator_config(_options("ffhq_256_sdf_tpu", stage_a), stage_a=stage_a)


def train_hparams(tpu: bool = False, batch: int = 8, ngp: bool = False) -> TrainHParams:
    """The training hyperparameters of ``ffhq_256_sdf.yaml`` (or, with
    ``tpu``, of ``ffhq_256_sdf_tpu.yaml``: bf16 G parameters); with ``ngp``
    those of ``ffhq_256_sdf_ngp.yaml`` (``ffhq_256_sdf_ngp_tpu.yaml``)."""
    name = "ffhq_256_sdf" + ("_ngp" if ngp else "") + ("_tpu" if tpu else "")
    return build.train_hparams(_options(name, True, ngp=ngp, batch=batch))


def discriminator_configs(size: int = 256) -> Tuple[VolumeRenderDiscConfig, StyleDiscConfig]:
    """(stage-A D on 64^2 thumbs with the viewpoint head, stage-B D at ``size``)."""
    vcfg, scfg = build.discriminator_configs(_options("ffhq_256_sdf", False))
    return vcfg, dataclasses.replace(scfg, size=size)
