"""Multi-view rendering and marching-cubes mesh export, port of the
repository's ``sdf_mesh.py``, with the same flags plus ``--device``.

    python -m sdface_gan_tpu_torch.sdf_mesh --config <yaml> --identities 8

Per identity: render an 8-view camera sweep at truncation 0.5 from the
full-pipeline generator (``out/<exp>/full_pipeline.pt``'s ``g_ema``) into
``out/<exp>/renders/``, then probe a 128^3 SDF volume with a second,
weight-sharing surface generator (``renderer_spatial_output_dim=128,
N_samples=128, full_pipeline=False``, reference ``sdf_mesh.py:243-261``),
frustum-align it and export ``out/<exp>/meshes/id<NNN>.obj`` through the
native marching cubes.  Test-mode rendering follows ``sdf_mesh.py:211-214``:
static view directions, forced background, no jitter.

The SIREN field runs through the port's fused kernel in both passes (the
surface probe is one call at B = 1, P = 128 * 128 * 128); NGP through its
hash-grid kernels.  Under the launcher the work is split over the ranks, as
the JAX version's mesh splits it: the 8 sweep views by batch, the probe by
its ray rows (``parallel.render_ray_sharded``: P = 128 * 128 / W * 128 per
rank); the world must divide both 8 and ``--surface_res``, and rank 0
writes the renders and meshes.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import replace

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Render views and extract meshes with the PyTorch port.")
    p.add_argument("--config", type=str, default="configs/256res/ffhq_256_sdf.yaml")
    p.add_argument("--sdf", type=int, default=1)
    p.add_argument("--ngp", type=int, default=0)
    p.add_argument("--fc", type=int, default=0)
    p.add_argument("--identities", type=int, default=8)
    p.add_argument("--size", type=int, default=None,
                   help="decoder output resolution (default: the config's "
                        "data.img_size); must match the checkpoint")
    p.add_argument("--truncation_ratio", type=float, default=0.5)
    p.add_argument("--surface_res", type=int, default=128)
    p.add_argument("--no_surface_renderings", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def mesh_configs(gcfg, surface_res: int):
    """(view-sweep config, surface-prober config) from the stage-B config:
    test-mode rendering, the fused SIREN field, and for the prober
    ``surface_res``² rays x ``surface_res`` samples without the decoder."""
    rcfg = replace(gcfg.renderer, static_viewdirs=True, force_background=True, perturb=0.0,
                   use_fused_kernel=gcfg.renderer.type == "sdf")
    view_cfg = replace(gcfg, renderer=rcfg)
    surf_cfg = replace(view_cfg, full_pipeline=False, renderer=replace(
        rcfg, out_im_res=surface_res, n_samples=surface_res, return_sdf=True,
        return_xyz=True))
    return view_cfg, surf_cfg


def render_views(model, cfg, z: torch.Tensor, cams, trunc, truncation: float,
                 field_pack=None):
    """(rgb [B, size, size, 3], thumb [B, res, res, 3]) of latents ``z``
    [B, style_dim] from cameras ``cams``, truncated toward ``trunc``, with
    the stored decoder noise."""
    from .models.generator import generator_forward

    with torch.inference_mode():
        out = generator_forward(model, cfg, [z], cams.extrinsics, cams.focal, cams.near,
                                cams.far, truncation=truncation, truncation_latent=trunc,
                                randomize_noise=False, field_pack=field_pack)
    return out.rgb, out.thumb_rgb


def probe_surface(surf_model, surf_cfg, z: torch.Tensor, cams, trunc, truncation: float,
                  field_pack=None, mesh=None) -> torch.Tensor:
    """The SDF volume [1, R, R, R, 1] of latent ``z`` [1, style_dim] from
    camera ``cams``, style truncated toward ``trunc``'s renderer mean; over
    ``mesh`` each rank renders a band of the ray rows, and every rank gets
    the whole volume."""
    from .models.generator import map_style
    from .parallel import render_ray_sharded

    with torch.inference_mode():
        style = map_style(surf_model, z)
        style = trunc[0] + truncation * (style - trunc[0])
        out = render_ray_sharded(surf_model.renderer, surf_cfg.renderer, cams.focal,
                                 cams.extrinsics, cams.near, cams.far, style, mesh,
                                 field_pack=field_pack)
    return out.sdf


def main(argv=None) -> dict:
    """Render and mesh; returns, per identity, the mesh's vertex and face
    counts (None without a mesh; rank 0's, over several ranks)."""
    args = parse_args(argv)

    from .parallel import close, make_mesh
    from .utils.device import resolve_device

    world = make_mesh(resolve_device(args.device))
    try:
        return _mesh_identities(args, world)
    finally:
        close(world)


def _mesh_identities(args, world) -> dict:
    """Render and mesh every identity over the data-parallel ``world``."""
    from .config import load_config
    from .config.build import generator_config
    from .config.sdf_options import get_vol_render_opt, rendering_overrides, resolve_renderer_type
    from .config.yaml_config import default_config_path
    from .geometry import generate_camera_params
    from .geometry.mesh import align_volume, extract_mesh_with_marching_cubes
    from .models.generator import Generator, mean_latent, pack_generator_for_inference
    from .ops.siren_kernel import pack_siren_field
    from .parallel import gather_rows, shard_batch
    from .training.loop import copy_matching
    from .utils.checkpoints import load_generator
    from .utils.device import disable_tf32
    from .utils.images import to_uint8, write_png

    device = world.device
    if 8 % world.world or args.surface_res % world.world:
        raise ValueError(f"the {world.world}-rank world must divide the 8 sweep views and "
                         f"--surface_res {args.surface_res}")
    disable_tf32()
    cfg = load_config(args.config, default_config_path())
    expname = cfg["training"]["out_dir"].split("/")[1]
    out_base = os.path.join("./out", expname)
    if args.size is None:
        args.size = int(cfg["data"].get("img_size", 256))
    render_dir = os.path.join(out_base, "renders")
    mesh_dir = os.path.join(out_base, "meshes")
    os.makedirs(render_dir, exist_ok=True)
    os.makedirs(mesh_dir, exist_ok=True)

    opt = get_vol_render_opt(expname, False, ngp=resolve_renderer_type(cfg, bool(args.ngp)),
                             fc=bool(args.fc), size=args.size,
                             extra_argv=rendering_overrides(cfg))
    gcfg, surf_cfg = mesh_configs(generator_config(opt, stage_a=False), args.surface_res)

    model = load_generator(out_base, "full_pipeline", gcfg, device=device)
    surf_model = Generator(surf_cfg, device=device)
    copy_matching(surf_model, model.state_dict())
    surf_model.eval()
    # NGP + yaml `rendering: pack_mb`: corner-packed inference tables
    pack_generator_for_inference(model)
    pack_generator_for_inference(surf_model)
    use_pack = gcfg.renderer.use_fused_kernel
    view_pack = pack_siren_field(model.renderer.network) if use_pack else None
    surf_pack = pack_siren_field(surf_model.renderer.network) if use_pack else None

    with torch.inference_mode():
        trunc = mean_latent(model, torch.Generator(device=device).manual_seed(1))
    gen = torch.Generator(device=device).manual_seed(0)
    res = gcfg.renderer.out_im_res
    meshes = {}
    for ident in range(args.identities):
        z = torch.randn((1, gcfg.style_dim), generator=gen, device=device)
        cams = generate_camera_params(res, gen, batch=1, sweep=True, device=device)
        views = render_views(model, gcfg, *shard_batch((z.repeat(8, 1), cams), world), trunc,
                             args.truncation_ratio, view_pack)
        rgb, thumb = (gather_rows(t, world).float().cpu().numpy() for t in views)
        for v, (img, th) in enumerate(zip(to_uint8(rgb), to_uint8(thumb))):
            if world.is_main:
                write_png(os.path.join(render_dir, f"id{ident:03d}_view{v}.png"), img)
                write_png(os.path.join(render_dir, f"id{ident:03d}_view{v}_thumb.png"), th)

        if args.no_surface_renderings:
            continue
        # frontal camera for the surface probe (azim = elev = 0)
        front = generate_camera_params(args.surface_res, batch=1,
                                       locations=torch.zeros((1, 2), device=device))
        sdf = probe_surface(surf_model, surf_cfg, z, front, trunc, args.truncation_ratio,
                            surf_pack, world)  # [1, R, R, S, 1]
        if not world.is_main:
            continue
        s_min, s_max = float(sdf.min()), float(sdf.max())
        if s_min > 0 or s_max < 0:
            # marching cubes would still emit the frustum shell (all-negative)
            # or nothing (all-positive): neither is a surface
            print(f"id{ident}: WARNING sdf has no zero crossing "
                  f"[{s_min:+.4f},{s_max:+.4f}] — degenerate geometry; "
                  "diagnose with sdface_gan_tpu_torch.probe_geometry")
        aligned = align_volume(sdf).cpu().numpy()
        try:
            mesh = extract_mesh_with_marching_cubes(aligned)
        except ValueError as e:
            print(f"id{ident}: marching cubes failed ({e}); "
                  "the SDF may not cross zero — train longer or check init")
            meshes[ident] = None
            continue
        mesh.export_obj(os.path.join(mesh_dir, f"id{ident:03d}.obj"))
        meshes[ident] = (len(mesh.verts), len(mesh.faces))
        print(f"id{ident}: {len(mesh.verts)} verts, {len(mesh.faces)} faces")
    return meshes


if __name__ == "__main__":
    main()
