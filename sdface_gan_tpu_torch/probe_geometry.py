"""Geometry health check for trained SDF checkpoints, port of the
repository's ``probe_geometry.py``, with the same flags plus ``--device``.

    python -m sdface_gan_tpu_torch.probe_geometry --config <yaml> --stage a|b [--mesh]

Stage-A training can keep rendering convincing images while the SDF carries
no surface, in two measured ways:

* **billboard** - SDF positive everywhere, all compositing weight on the
  far-plane background sample; fg_mass -> 0.
* **fog** - SDF negative everywhere, a uniform low-density field that
  paints the background from inside the frustum; fg_mass -> 1.

This entry probes a frontal SDF volume per identity and prints what tells
them apart: the zero-crossing fraction of the rays, the SDF range, the
mean occupancy sigmoid(-sdf/beta), the per-pixel background weight and,
with ``--mesh``, marching-cubes vertex and face counts; then a verdict
(BILLBOARD / FOG / WEAK / GEOMETRY).  The probe rig matches ``sdf_mesh``'s
surface generator.  It reads the port's checkpoints: stage a
``out/<exp>/volume_renderer/vol_renderer.pt``, stage b
``out/<exp>/full_pipeline.pt``, or else the stage's latest ``models_*``.
The latents come from a seeded ``torch.Generator``, not the JAX package's
keys, so its identities are not the JAX probe's.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import replace
from typing import Optional

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Probe SDF geometry health with the PyTorch port.")
    p.add_argument("--config", type=str, default="configs/256res/ffhq_256_sdf.yaml")
    p.add_argument("--sdf", type=int, default=1)
    p.add_argument("--ngp", type=int, default=0)
    p.add_argument("--fc", type=int, default=0)
    p.add_argument("--stage", choices=["a", "b"], default="a",
                   help="a: volume_renderer checkpoints; b: full_pipeline")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint name (default: final artifact, falling "
                        "back to the latest models_*)")
    p.add_argument("--which", type=str, default="g_ema", choices=["g", "g_ema"])
    p.add_argument("--identities", type=int, default=4)
    p.add_argument("--res", type=int, default=64,
                   help="probe volume resolution (res^2 rays x res samples)")
    p.add_argument("--size", type=int, default=None,
                   help="decoder output resolution (default: the config's "
                        "data.img_size); must match the checkpoint for "
                        "stage-b probes")
    p.add_argument("--mesh", action="store_true",
                   help="also run marching cubes and report vert/face counts")
    p.add_argument("--out", type=str, default=None,
                   help="experiment dir override (default ./out/<expname> "
                        "from the config)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def probe_renderer_config(rcfg, res: int):
    """The probe rig: ``res``² rays x ``res`` samples, SDF and surface
    points returned, no jitter, static view directions."""
    return replace(rcfg, out_im_res=res, n_samples=res, return_sdf=True, return_xyz=True,
                   perturb=0.0, static_viewdirs=True)


def probe(model, rcfg, z: torch.Tensor, cams, field_pack=None, mesh: bool = False) -> dict:
    """Render the probe volume of latent ``z`` [1, style_dim] from camera
    ``cams`` and return its statistics: ``sdf_min``, ``sdf_max``,
    ``crossing`` (fraction of rays whose SDF changes sign), ``occupancy``
    (mean sigmoid(-sdf/beta)), ``bg_mean`` / ``bg_min`` / ``bg_max`` (the
    per-pixel background weight), ``beta``; with ``mesh``, ``mesh_verts``
    and ``mesh_faces`` (None when marching cubes finds no volume)."""
    from .geometry.mesh import align_volume, extract_mesh_with_marching_cubes
    from .models.generator import map_style
    from .models.renderer import render

    with torch.inference_mode():
        style = map_style(model, z)
        out = render(model.renderer, rcfg, cams.focal, cams.extrinsics, cams.near, cams.far,
                     style, field_pack=field_pack)
        s = out.sdf.float().cpu().numpy()
        mask = out.mask.float().cpu().numpy()
        aligned = align_volume(out.sdf).cpu().numpy() if mesh else None
    beta = float(model.renderer.sigmoid_beta.detach().float().cpu()[0])
    stats = dict(
        sdf_min=float(s.min()), sdf_max=float(s.max()),
        crossing=float(np.mean((s.min(axis=-2) < 0) & (s.max(axis=-2) > 0))),
        occupancy=float(np.mean(1.0 / (1.0 + np.exp(np.clip(s / beta, -30, 30))))),
        bg_mean=float(mask.mean()), bg_min=float(mask.min()), bg_max=float(mask.max()),
        beta=beta)
    if mesh:
        try:
            m = extract_mesh_with_marching_cubes(aligned)
            stats["mesh_verts"], stats["mesh_faces"] = len(m.verts), len(m.faces)
        except ValueError:
            stats["mesh_verts"] = stats["mesh_faces"] = None
    return stats


def verdict(stats: dict) -> str:
    """One identity's verdict from its statistics."""
    if stats["sdf_min"] > 0:
        return ("BILLBOARD (sdf positive everywhere: no surface, "
                "images live on the background sample)")
    if stats["sdf_max"] < 0:
        return ("FOG (sdf negative everywhere: background "
                "self-painted by density; meshes are the frustum shell)")
    if stats["crossing"] < 0.01:
        return "WEAK (zero crossing on <1% of rays)"
    return "GEOMETRY (zero-level set present)"


def stats_line(ident: int, stats: dict) -> str:
    line = (f"id{ident}: sdf[{stats['sdf_min']:+.4f},{stats['sdf_max']:+.4f}] "
            f"ray-crossing {stats['crossing']:.3f} occupancy {stats['occupancy']:.3f} "
            f"bg-weight mean {stats['bg_mean']:.3f} [{stats['bg_min']:.3f},{stats['bg_max']:.3f}]")
    if "mesh_verts" in stats:
        line += (" mesh EMPTY" if stats["mesh_verts"] is None
                 else f" mesh {stats['mesh_verts']}v/{stats['mesh_faces']}f")
    return line


def main(argv=None) -> Optional[str]:
    """Probe and print; returns the verdict."""
    args = parse_args(argv)

    from .config import load_config
    from .config.build import generator_config
    from .config.sdf_options import get_vol_render_opt, rendering_overrides, resolve_renderer_type
    from .config.yaml_config import default_config_path
    from .geometry import generate_camera_params
    from .models.generator import Generator, pack_generator_for_inference
    from .ops.siren_kernel import pack_siren_field
    from .training.loop import copy_matching
    from .utils.checkpoints import checkpoint_exists, latest_checkpoint_step, load_generator
    from .utils.device import disable_tf32, resolve_device

    device = resolve_device(args.device)
    disable_tf32()
    cfg = load_config(args.config, default_config_path())
    expname = cfg["training"]["out_dir"].split("/")[1]
    out_base = args.out or os.path.join("./out", expname)
    if args.size is None:
        args.size = int(cfg["data"]["img_size"])

    stage_a = args.stage == "a"
    opt = get_vol_render_opt(expname, stage_a, ngp=resolve_renderer_type(cfg, bool(args.ngp)),
                             fc=bool(args.fc), size=args.size,
                             extra_argv=rendering_overrides(cfg))
    gcfg = generator_config(opt, stage_a=stage_a)
    rcfg = probe_renderer_config(gcfg.renderer, args.res)
    # the fused SIREN field where the renderer outputs features (stage b)
    if rcfg.type == "sdf" and rcfg.output_features:
        rcfg = replace(rcfg, use_fused_kernel=True)

    ckpt_dir = out_base if not stage_a else os.path.join(out_base, "volume_renderer")
    name = args.ckpt
    if name is None:
        final = "vol_renderer" if stage_a else "full_pipeline"
        if checkpoint_exists(ckpt_dir, final):
            name = final
        else:
            step = latest_checkpoint_step(ckpt_dir)
            if step is None:
                raise SystemExit(f"no checkpoint found under {ckpt_dir}")
            name = f"models_{step:07d}"
    print(f"probing {ckpt_dir}/{name} [{args.which}] at {args.res}^3")

    model = load_generator(ckpt_dir, name, gcfg, which=args.which, device=device)
    if not stage_a:
        # weight-sharing surface prober (renderer subtree only)
        surf = Generator(replace(gcfg, full_pipeline=False, renderer=rcfg), device=device)
        copy_matching(surf, model.state_dict())
        model = surf.eval()
    pack_generator_for_inference(model)
    field_pack = pack_siren_field(model.renderer.network) if rcfg.use_fused_kernel else None

    front = generate_camera_params(args.res, batch=1, locations=torch.zeros((1, 2), device=device))
    gen = torch.Generator(device=device).manual_seed(100)
    verdicts = []
    for ident in range(args.identities):
        z = torch.randn((1, gcfg.style_dim), generator=gen, device=device)
        stats = probe(model, rcfg, z, front, field_pack=field_pack, mesh=args.mesh)
        print(stats_line(ident, stats))
        verdicts.append(verdict(stats))

    print(f"beta {float(model.renderer.sigmoid_beta.detach().float().cpu()[0]):.4f}")
    final_verdict = max(set(verdicts), key=verdicts.count)
    print("verdict:", final_verdict)
    return final_verdict


if __name__ == "__main__":
    main()
