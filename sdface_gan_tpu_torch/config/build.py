"""Option tree -> the port's model and training dataclasses, port of
``sdface_gan_tpu/config/build.py`` (``renderer_config``,
``generator_config``, ``discriminator_configs``, ``train_hparams``).
Fields the option tree does not set (``channel_base``,
``use_fused_kernel``, ``return_weights``, ``eikonal_mode``) keep their
defaults, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

from ..models.discriminator import StyleDiscConfig, VolumeRenderDiscConfig
from ..models.generator import GeneratorConfig
from ..models.renderer import RendererConfig
from ..training.steps import CameraHParams, TrainHParams
from .node import ConfigNode
from .sdf_options import get_vol_render_opt, rendering_overrides, resolve_renderer_type


def renderer_config(opt: ConfigNode, stage_a: bool) -> RendererConfig:
    r = opt.rendering
    m = opt.model
    rtype = "fc" if r.get("fc") else r.get("type", "sdf")
    return RendererConfig(
        type=rtype,
        out_im_res=m.renderer_spatial_output_dim,
        n_samples=r.N_samples,
        style_dim=m.style_dim,
        width=r.width,
        depth=r.depth,
        offset_sampling=not r.no_offset_sampling,
        static_viewdirs=r.static_viewdirs,
        z_normalize=not r.no_z_normalize,
        with_sdf=not r.no_sdf,
        force_background=r.force_background,
        output_features=not (stage_a or r.get("no_features_output", False)),
        return_xyz=r.return_xyz,
        return_sdf=r.return_sdf,
        perturb=r.perturb,
        raw_noise_std=r.raw_noise_std,
        bg_mode=r.get("bg_mode", "lastsample"),
        view_independent=r.get("view_independent", False),
        eikonal_subsample=r.get("eikonal_subsample", 0),
        remat=not r.get("no_remat", False),
        ngp_num_levels=r.get("num_levels", 16),
        ngp_level_dim=r.get("level_dim", 2),
        ngp_finest_res=r.get("finest_res", 4096),
        ngp_log2_hashmap_size=r.get("log2_hashmap_size", 19),
        ngp_pack_mb=r.get("pack_mb", 0),
    )


def generator_config(opt: ConfigNode, stage_a: bool) -> GeneratorConfig:
    m = opt.model
    return GeneratorConfig(
        size=m.size,
        style_dim=m.style_dim,
        full_pipeline=not stage_a,
        freeze_renderer=(not stage_a) and m.freeze_renderer,
        channel_multiplier=m.channel_multiplier,
        lr_mapping=m.lr_mapping,
        renderer=renderer_config(opt, stage_a),
    )


def discriminator_configs(
    opt: ConfigNode,
) -> Tuple[VolumeRenderDiscConfig, StyleDiscConfig]:
    m = opt.model
    return (
        VolumeRenderDiscConfig(
            in_res=m.renderer_spatial_output_dim,
            viewpoint_head=not m.no_viewpoint_loss,
        ),
        StyleDiscConfig(size=m.size, channel_multiplier=m.channel_multiplier),
    )


def train_hparams(opt: ConfigNode) -> TrainHParams:
    t = opt.training
    c = opt.camera
    return TrainHParams(
        batch=t.batch,
        style_dim=opt.model.style_dim,
        r1=t.r1,
        view_lambda=t.view_lambda,
        eikonal_lambda=t.eikonal_lambda,
        min_surf_lambda=t.min_surf_lambda,
        min_surf_beta=t.min_surf_beta,
        sparsity_lambda=t.get("sparsity_lambda", 0.0),
        distortion_lambda=t.get("distortion_lambda", 0.0),
        smooth_lambda=t.get("smooth_lambda", 1000.0),
        g_param_dtype=t.get("g_param_dtype", "float32"),
        mixing=t.mixing,
        a_d_reg_every=t.get("a_d_reg_every", 1),
        d_reg_every=t.d_reg_every,
        g_reg_every=t.g_reg_every,
        path_regularize=t.path_regularize,
        path_batch_shrink=t.path_batch_shrink,
        camera=CameraHParams(
            uniform=c.uniform,
            azim=c.azim,
            elev=c.elev,
            fov=c.fov,
            dist_radius=c.dist_radius,
        ),
    )


def stage_options(cfg: ConfigNode, stage_a: bool, *, ngp: bool = False, fc: bool = False,
                  wod: bool = False, batch: int = 8) -> ConfigNode:
    """One stage's option tree from a loaded yaml config, resolved as the
    SDF train entry resolves it (``train.py`` ``train_sdf``): the
    experiment name from ``training.out_dir``, the architecture from
    ``--ngp`` and ``rendering.type``, the size from ``data.img_size``, and
    the yaml's ``rendering:`` / ``train_args:`` flags."""
    return get_vol_render_opt(
        cfg["training"]["out_dir"].split("/")[1], stage_a,
        ngp=resolve_renderer_type(cfg, ngp), fc=fc, wod=wod,
        size=cfg["data"].get("img_size", 256), batch=batch,
        extra_argv=rendering_overrides(cfg))
