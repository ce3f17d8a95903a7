"""SDF pipeline options: typed defaults and per-stage derivations, the
port's copy of ``sdface_gan_tpu/config/sdf_options.py`` (``sdf_defaults``,
``parse_sdf_options``, ``resolve_renderer_type``, ``rendering_overrides``,
``get_vol_render_opt``): the same group and knob names and defaults, so a
yaml file resolves to the same option tree in both packages.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from .node import ConfigNode


def sdf_defaults() -> ConfigNode:
    """Default option tree (values match reference ``SDFOptions``)."""
    return ConfigNode(
        dataset=dict(dataset_path="./data/ffhq"),
        experiment=dict(
            config=None,
            expname="ffhq1024x1024",
            ckpt="300000",
            continue_training=False,
        ),
        training=dict(
            checkpoints_dir="./out",
            iter=300000,
            batch=4,
            chunk=1,
            val_n_sample=8,
            d_reg_every=16,
            g_reg_every=4,
            # stage-A lazy-R1 interval (1 = reference parity: R1 every D
            # step, training_utils.py:345-397; >1 = StyleGAN2 lazy-reg
            # convention applied to stage A — a TPU-config knob)
            a_d_reg_every=1,
            local_rank=0,
            mixing=0.9,
            lr=0.002,
            r1=10.0,
            view_lambda=15.0,
            eikonal_lambda=0.1,
            min_surf_lambda=0.05,
            min_surf_beta=100.0,
            # occupancy sparsity prior (not in reference; breaks the
            # fog/geometry tie on background-matched synthetic data,
            # docs/TRAINING_RUN.md)
            sparsity_lambda=0.0,
            # mip-NeRF 360 distortion prior (not in reference; concentrates
            # per-ray weight into a thin interval — the anti-fog counter
            # that never taxes a saturated interior, docs/TRAINING_RUN.md)
            distortion_lambda=0.0,
            smooth_lambda=1000.0,  # hardcoded 1000x in reference training_utils.py:437
            # stage-A G-step compute dtype ("float32" | "bfloat16"); the
            # optimizer/EMA master params stay f32 (training/steps.py)
            g_param_dtype="float32",
            path_regularize=2.0,
            path_batch_shrink=2,
            wandb=False,
            no_sphere_init=False,
            seed=0,
        ),
        inference=dict(
            results_dir="./evaluations",
            truncation_ratio=0.5,
            truncation_mean=10000,
            identities=16,
            num_views_per_id=1,
            no_surface_renderings=False,
            fixed_camera_angles=False,
            azim_video=False,
        ),
        model=dict(
            size=256,
            style_dim=256,
            channel_multiplier=2,
            n_mlp=8,
            lr_mapping=0.01,
            renderer_spatial_output_dim=64,
            project_noise=False,
            freeze_renderer=False,
            no_viewpoint_loss=False,
            psp=False,
        ),
        camera=dict(
            uniform=False,
            azim=0.3,
            elev=0.15,
            fov=6.0,
            dist_radius=0.12,
        ),
        rendering=dict(
            depth=8,
            width=256,
            no_sdf=False,
            no_z_normalize=False,
            static_viewdirs=False,
            N_samples=24,
            no_offset_sampling=False,
            perturb=1.0,
            raw_noise_std=0.0,
            force_background=False,
            return_xyz=False,
            return_sdf=False,
            type="sdf",  # 'sdf' | 'ngp'; set by --ngp (training_utils.py:189)
            bg_mode="lastsample",  # 'lastsample' | 'white' | 'gray' | 'black'
            # zero the view branch of the field (kills the light-field
            # painting shortcut on synthetic data, docs/TRAINING_RUN.md)
            view_independent=False,
            fc=False,
            no_features_output=False,
            # eikonal point budget: 0 = all rendered points (reference
            # semantics); M > 0 = M fresh frustum points per batch element
            # — detaches the second-order pass from the render graph,
            # measured 4.3x on the stage-A G step (docs/PERFORMANCE.md)
            eikonal_subsample=0,
            # skip field rematerialization (only safe when the backward
            # fits HBM, e.g. bf16 + eikonal_subsample)
            no_remat=False,
            # NGP grid geometry (reference hardcodes, sdf_model.py:1534-1545);
            # overridable per-experiment via the yaml `rendering:` section
            num_levels=16,
            level_dim=2,
            finest_res=4096,
            log2_hashmap_size=19,
            # corner-packed NGP inference tables, MB budget (0 = off;
            # 64 = measured optimum, scripts/bench_packed_gather.py) —
            # serving/eval only, training ignores it
            pack_mb=0,
        ),
    )


def parse_sdf_options(argv: Optional[Sequence[str]] = None) -> ConfigNode:
    """Parse CLI overrides onto the default tree (configargparse-compatible flags)."""
    defaults = sdf_defaults()
    p = argparse.ArgumentParser(add_help=False)
    for group, node in defaults.items():
        for key, val in node.items():
            flag = f"--{key}"
            if any(a.option_strings == [flag] for a in p._actions):
                continue
            if isinstance(val, bool):
                p.add_argument(flag, action="store_true", default=val)
            elif val is None:
                p.add_argument(flag, type=str, default=None)
            else:
                p.add_argument(flag, type=type(val), default=val)
    args, _ = p.parse_known_args(list(argv) if argv is not None else [])
    out = defaults.copy()
    for group, node in out.items():
        for key in node:
            if hasattr(args, key):
                node[key] = getattr(args, key)
    return out


# rendering: keys consumed by the GIRAFFE family / render.py rather than
# parse_sdf_options; every config inherits them from configs/default.yaml,
# so they are skipped (not errors) when flattening for the SDF stages.
# ``type`` is handled by resolve_renderer_type (yaml-settable architecture
# selection), not flattened into parse_sdf_options flags.
_NON_SDF_RENDERING_KEYS = frozenset({"render_program", "render_dir", "type"})


def resolve_renderer_type(cfg, ngp: bool) -> bool:
    """Combine the CLI ``--ngp`` flag with an optional yaml ``rendering.type``.

    The reference selects the hash-grid architecture only via ``--ngp 1``
    (``training_utils.py:189``); the yaml cannot.  That produced a measured
    footgun here (VERDICT r4): a config inheriting an NGP arm's grid knobs
    trains/evals as SIREN unless the flag is remembered, and the knobs are
    silently inert.  Configs may now pin ``rendering: type: sdf|ngp``:

    * yaml ``type`` absent → the CLI flag decides (reference behavior);
    * yaml ``type: ngp`` → NGP, with or without the flag;
    * yaml ``type: sdf`` + ``--ngp 1`` → raise: the yaml says this config's
      checkpoints are SIREN trees, so honoring the flag would produce a
      param-tree mismatch (or a fresh run nobody intended).
    """
    yaml_type = (cfg.get("rendering") or {}).get("type")
    if yaml_type is None:
        return ngp
    if yaml_type not in ("sdf", "ngp"):
        raise ValueError(
            f"rendering.type must be 'sdf' or 'ngp', got {yaml_type!r}"
        )
    if ngp and yaml_type == "sdf":
        raise ValueError(
            "--ngp 1 conflicts with the yaml's 'rendering: type: sdf' — "
            "this config pins a SIREN architecture (its checkpoints are "
            "SIREN param trees); drop the flag, or use an NGP config"
        )
    return yaml_type == "ngp"


def rendering_overrides(cfg) -> list:
    """Flatten the yaml ``rendering:`` and ``train_args:`` sections into
    ``extra_argv`` flags for :func:`get_vol_render_opt` (e.g. the TPU-tuned
    NGP grid in ``configs/256res/ffhq_256_sdf_ngp_tpu.yaml``, or a per-
    experiment ``min_surf_lambda`` — any flag ``parse_sdf_options`` knows).

    Unknown keys raise: ``parse_sdf_options`` uses ``parse_known_args``,
    so a typo'd geometry-critical knob (``sparsity_lamda``) would otherwise
    be dropped silently and the run would collapse into the billboard/fog
    regimes documented in docs/TRAINING_RUN.md with nothing in the logs."""
    known = set()
    for _group, node in sdf_defaults().items():
        known |= set(node.keys())
    extra = []
    for section in ("rendering", "train_args"):
        for k, v in (cfg.get(section) or {}).items():
            if k in _NON_SDF_RENDERING_KEYS:
                continue
            if k not in known:
                raise ValueError(
                    f"unknown {section}: key {k!r} in the yaml config — "
                    "not a parse_sdf_options flag (typo?); known keys are "
                    "the sdf_defaults() option names"
                )
            if isinstance(v, bool):  # store_true flags: present iff truthy
                if v:
                    extra += [f"--{k}"]
            else:
                extra += [f"--{k}", str(v)]
    return extra


def get_vol_render_opt(
    expname: str,
    need_train_vol_render: bool,
    *,
    ngp: bool = False,
    fc: bool = False,
    psp: bool = False,
    wod: bool = False,
    size: int = 256,
    batch: int = 8,
    chunk: int = 2,
    extra_argv: Optional[Sequence[str]] = None,
) -> ConfigNode:
    """Build the per-stage option tree.

    Mirrors reference ``get_vol_render_opt`` (``training_utils.py:144-193``):
    stage A (``need_train_vol_render=True``) trains the volume renderer
    against the CoordConv discriminator at 64² with no feature output;
    stage B freezes the renderer and trains the StyleGAN decoder at ``size``.
    """
    opt = parse_sdf_options(
        ["--expname", expname, "--size", str(size), "--batch", str(batch),
         "--chunk", str(chunk)] + list(extra_argv or [])
    )
    opt.training.camera = opt.camera.copy()
    opt.training.renderer_output_size = opt.model.renderer_spatial_output_dim
    opt.training.style_dim = opt.model.style_dim
    opt.model.no_viewpoint_loss = opt.training.view_lambda == 0.0

    if need_train_vol_render:
        opt.model.freeze_renderer = False
        opt.training.with_sdf = not opt.rendering.no_sdf
        if opt.training.with_sdf and (
            opt.training.min_surf_lambda > 0 or opt.training.sparsity_lambda > 0
        ):
            opt.rendering.return_sdf = True
        opt.training.iter = 200001
        opt.rendering.no_features_output = True
    else:
        opt.training.size = opt.model.size
        opt.model.freeze_renderer = True
        opt.training.with_sdf = not opt.rendering.no_sdf

    opt.training.start_iter = 0
    opt.training.wod = wod
    opt.rendering.type = "ngp" if ngp else "sdf"
    opt.rendering.fc = fc
    opt.model.psp = psp
    return opt
