"""GIRAFFE render programs and mesh extraction, port of
``sdface_gan_tpu/giraffe/rendering.py``.

Each program fixes the latent codes and sweeps one control (object
rotation, horizontal / depth translation, appearance / shape slerp of the
objects or the background, a circling object, camera elevation, objects
revealed one by one) and writes the frames as one PNG contact sheet
(samples x steps).  No ``.mp4`` is written: the port has no video
encoder.  Draws come from one ``torch.Generator`` in the order codes,
target codes (the interpolation programs only), transforms (the circle
program with more than two boxes only).
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import List, Optional

import numpy as np
import torch

from ..geometry.mesh import Mesh
from ..native import marching_cubes
from ..utils.images import save_image_grid
from .bbox import fixed_transformations, sample_transformations
from .camera import interpolate_sphere
from .generator import (
    GiraffeConfig,
    GiraffeGenerator,
    LatentCodes,
    _device,
    fixed_camera,
    giraffe_forward,
    sample_latent_codes,
)

PROGRAMS = (
    "object_rotation",
    "object_translation_horizontal",
    "object_translation_vertical",
    "interpolate_app",
    "interpolate_app_bg",
    "interpolate_shape",
    "interpolate_shape_bg",
    "object_translation_circle",
    "render_camera_elevation",
    "render_add_objects",
    "render_add_cars",
    "render_add_clevr10",
    "render_add_clevr6",
)

# The scripted reveals (reference rendering.py:404-585): fixed fractional
# scales, translations and rotations; every step renders all boxes, those
# not yet revealed masked to zero density.
_ADD_LAYOUTS = {
    "render_add_cars": dict(
        n_objs=6,
        val_s=[[-1.0, -1.0, -1.0]] * 6,
        val_t=[[-0.7, -0.8, 0.0], [-0.7, 0.5, 0.0], [-0.7, 1.8, 0.0],
               [1.5, -0.8, 0.0], [1.5, 0.5, 0.0], [1.5, 1.8, 0.0]],
        val_r=[0.5] * 6,
        reveal=tuple(range(1, 7)),
    ),
    "render_add_clevr10": dict(
        n_objs=12,
        val_s=[[0.0, 0.0, 0.0]] * 12,
        val_t=[coord for i in range(6)
               for coord in ([(0.0, 0.5, 1.0)[i % 3], 0.0 if i < 3 else 0.8, 0.0],
                             [(0.0, 0.5, 1.0)[i % 3], (0.0 if i < 3 else 0.8) + 0.4, 0.0])],
        val_r=[0.0] * 12,
        reveal=tuple(range(2, 13, 2)),
    ),
    "render_add_clevr6": dict(
        n_objs=6,
        val_s=[[0.0, 0.0, 0.0]] * 6,
        val_t=[[0.2 if i % 2 == 0 else 0.8, (0.0, 0.0, 0.5, 0.5, 1.0, 1.0)[i], 0.0]
               for i in range(6)],
        val_r=[0.0] * 6,
        reveal=tuple(range(1, 7)),
    ),
}
CODE_TMP = 0.65  # the programs' latent temperature


def _frame(img: torch.Tensor) -> np.ndarray:
    return (img * 2.0 - 1.0).cpu().numpy()  # [-1, 1] for the sheet


def _reveal_mask(n_boxes: int, count: int, n_samples: int, device) -> torch.Tensor:
    return (torch.arange(n_boxes, device=device) < count).float()[None].repeat(n_samples, 1)


def _scripted_add_objects(g: GiraffeGenerator, cfg: GiraffeConfig, program: str,
                          generator: torch.Generator, n_samples: int) -> List[np.ndarray]:
    """The cars / clevr10 / clevr6 reveals: ``n_boxes`` replaced by the
    layout's object count."""
    lay = _ADD_LAYOUTS[program]
    n_objs = lay["n_objs"]
    device = _device(g)
    scfg = replace(cfg, bbox=replace(cfg.bbox, n_boxes=n_objs), sample_object_existance=False)
    codes = sample_latent_codes(generator, scfg, n_samples, tmp=CODE_TMP, device=device)
    cams = fixed_camera(scfg, n_samples, val_v=0.0, device=device)
    trans = fixed_transformations(scfg.bbox, n_samples, val_s=lay["val_s"], val_t=lay["val_t"],
                                  val_r=lay["val_r"], device=device)
    return [_frame(giraffe_forward(g, scfg, latent_codes=codes, camera_matrices=cams,
                                   transformations=trans, mode="eval",
                                   object_mask=_reveal_mask(n_objs, count, n_samples, device)))
            for count in lay["reveal"]]


def _step_codes(program: str, codes: LatentCodes, codes2: LatentCodes, t: float) -> LatentCodes:
    """The interpolation programs' codes at ``t``: one field slerped to ``codes2``."""
    name = {"interpolate_app": "z_app_obj", "interpolate_shape": "z_shape_obj",
            "interpolate_app_bg": "z_app_bg", "interpolate_shape_bg": "z_shape_bg"}[program]
    return codes._replace(**{name: interpolate_sphere(getattr(codes, name),
                                                      getattr(codes2, name), t)})


@torch.no_grad()
def render_program(
    g: GiraffeGenerator,
    cfg: GiraffeConfig,
    program: str,
    out_dir: str,
    n_samples: int = 4,
    n_steps: int = 16,
    generator: Optional[torch.Generator] = None,
    codes: Optional[LatentCodes] = None,
    export_meshes: bool = False,
    mesh_resolution: int = 64,
) -> List[np.ndarray]:
    """Run one program; returns its frames ([N, H, W, 3] in [-1, 1] each)
    and writes ``<out_dir>/<program>.png``.  ``codes`` replaces the sampled
    codes (``render --vae``); ``export_meshes`` also writes one
    ``{i:02d}_rotation.ply`` per sample after ``object_rotation``."""
    if program not in PROGRAMS:
        raise ValueError(f"unknown render program {program}; options: {PROGRAMS}")
    os.makedirs(out_dir, exist_ok=True)
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    device = _device(g)

    if program in _ADD_LAYOUTS:
        frames = _scripted_add_objects(g, cfg, program, generator, n_samples)
        _save_outputs(frames, out_dir, program, n_samples)
        return frames

    if codes is None:
        codes = sample_latent_codes(generator, cfg, n_samples, tmp=CODE_TMP, device=device)
    n_samples = int(codes.z_shape_obj.shape[0])
    cams = fixed_camera(cfg, n_samples, device=device)
    n_boxes = cfg.n_boxes
    codes2 = (sample_latent_codes(generator, cfg, n_samples, tmp=CODE_TMP, device=device)
              if program.startswith("interpolate_") else None)
    circle_trans = (sample_transformations(generator, cfg.bbox, n_samples, device=device)
                    if program == "object_translation_circle" and n_boxes > 2 else None)
    # object_rotation sweeps a full turn only when the config allows one
    r_scale = (0.0, 1.0) if cfg.bbox.rotation_range == (0.0, 1.0) else (0.1, 0.9)

    def fixed(**vals):
        return fixed_transformations(cfg.bbox, n_samples, device=device, **vals)

    half = [[0.5] * 3] * n_boxes
    # every box at the ranges' middle: the JAX programs pass one box's
    # values here, and its indexing clamps, so each box takes box 0's
    centre = dict(val_s=half, val_t=half, val_r=[0.5] * n_boxes)
    frames: List[np.ndarray] = []
    for step in range(n_steps):
        t = step / max(n_steps - 1, 1)
        step_codes, step_cams, mask = codes, cams, None
        if program == "object_rotation":
            r = r_scale[0] + t * (r_scale[1] - r_scale[0])
            trans = fixed(val_r=[r] * n_boxes, val_s=half, val_t=half)
        elif program == "object_translation_horizontal":
            trans = fixed(val_r=[0.0] * n_boxes, val_s=half, val_t=[[t, 0.5, 0.5]] * n_boxes)
        elif program == "object_translation_vertical":
            trans = fixed(val_r=[0.0] * n_boxes, val_s=half, val_t=[[0.5, t, 0.5]] * n_boxes)
        elif program.startswith("interpolate_"):
            step_codes = _step_codes(program, codes, codes2, t)
            trans = fixed(**centre)
        elif program == "object_translation_circle":
            ci = float(np.cos(2 * np.pi * t) * 0.5 + 0.5)
            si = float(np.sin(2 * np.pi * t) * 0.5 + 0.5)
            if circle_trans is None:
                trans = fixed(val_s=[[0.0] * 3] * n_boxes,
                              val_t=[[0.5, 0.5, 0.0]] * (n_boxes - 1) + [[ci, si, 0.0]],
                              val_r=[0.0] * n_boxes)
            else:
                s10, t10, r10 = circle_trans
                _, ti, _ = fixed(val_s=[[0.0] * 3], val_t=[[ci, si, 0.0]], val_r=[0.0])
                t10 = t10.clone()
                t10[:, -1:] = ti
                trans = (s10, t10, r10)
        elif program == "render_camera_elevation":
            step_cams = fixed_camera(cfg, n_samples, val_v=0.1 + t * 0.8, device=device)
            trans = fixed(**centre)
        else:  # render_add_objects: one more object per segment
            trans = fixed(val_s=half,
                          val_t=[[(j + 1) / (n_boxes + 1), 0.5, 0.5] for j in range(n_boxes)],
                          val_r=[0.0] * n_boxes)
            n_visible = 1 + int(t * (n_boxes - 1) + 1e-6) if n_boxes > 1 else 1
            mask = _reveal_mask(n_boxes, n_visible, n_samples, device)
        frames.append(_frame(giraffe_forward(g, cfg, latent_codes=step_codes,
                                             camera_matrices=step_cams, transformations=trans,
                                             mode="eval", object_mask=mask)))

    if program == "object_rotation" and export_meshes:
        for i in range(n_samples):
            codes_i = LatentCodes(*(c[i:i + 1] for c in codes))
            mesh = extract_giraffe_mesh(g, cfg, codes=codes_i, resolution=mesh_resolution)
            mesh.export_ply(os.path.join(out_dir, f"{i:02d}_rotation.ply"))

    _save_outputs(frames, out_dir, program, n_samples)
    return frames


def _save_outputs(frames: List[np.ndarray], out_dir: str, program: str, n_samples: int) -> None:
    save_image_grid(np.concatenate(frames, axis=0), os.path.join(out_dir, f"{program}.png"),
                    nrow=n_samples)
    print(f"{program}: wrote the PNG sheet; no .mp4 (the port has no video encoder)")


@torch.no_grad()
def extract_giraffe_mesh(
    g: GiraffeGenerator,
    cfg: GiraffeConfig,
    codes: LatentCodes,
    resolution: int = 128,
    level: float = 0.005,
) -> Mesh:
    """Object 0's density on a ``resolution``^3 grid over the box [-1, 1]^3
    (in chunks of 65,536 points, the points passed as the view directions
    too, as the JAX function passes them), as alpha
    ``1 - exp(-max(sigma, 0) * step)``, triangulated at ``level`` by
    marching cubes."""
    lin = torch.linspace(-1.0, 1.0, resolution, device=_device(g))
    gx, gy, gz = torch.meshgrid(lin, lin, lin, indexing="ij")
    pts = torch.stack([gx, gy, gz], -1).reshape(1, -1, 3)
    chunk = 65536
    sigmas = []
    for i in range(0, pts.shape[1], chunk):
        p = pts[:, i:i + chunk]
        _, sigma = g.decoder(p, p, codes.z_shape_obj[:, 0], codes.z_app_obj[:, 0])
        sigmas.append(sigma.cpu().numpy())
    sigma = np.concatenate(sigmas, axis=1).reshape(resolution, resolution, resolution)
    step = 2.0 / resolution
    alpha = 1.0 - np.exp(-np.maximum(sigma, 0.0) * step)
    verts, faces = marching_cubes(alpha, level)
    verts = verts / (resolution - 1) * 2.0 - 1.0
    return Mesh(verts=verts.astype(np.float32), faces=faces.astype(np.int32))
