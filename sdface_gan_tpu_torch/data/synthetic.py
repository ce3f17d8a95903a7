"""Procedural pose-varied dataset, port of
``scripts/make_synthetic_dataset.py`` (``render_head``, ``main``).

    python -m sdface_gan_tpu_torch.data.synthetic --out <store> --n 4000 --res 64

Real face data is not in the repository, so training dynamics are checked
against procedurally rendered "heads": lambertian ellipsoids with
object-space features (hair cap, eye spots, mouth band) lit by a fixed
world light, photographed by the SAME camera distribution the generator
samples from (``geometry/cameras.py``: unit-sphere look-at cameras,
azim ~ N(0, 0.3), elev ~ N(0, 0.15), half-fov 6 deg, near/far = 1 -/+
0.12).  That gives the discriminator a real joint (pose, appearance)
distribution over a consistent 3D structure.

Identity variation: ellipsoid axis scales, skin/hair/background colors,
eye spacing/height, mouth width.  Pose variation: the camera, as above.

Output: PNGs rendered straight at the target resolution with the port's
encoder (``png.py``), then packed into a record store by the port's
``prepare_data`` (the path a real-image user takes).  ``render_head`` is
numpy, draw for draw the script's, so one seed gives the same images.
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np


def _look_at(azim: float, elev: float) -> tuple[np.ndarray, np.ndarray]:
    """Camera-to-world rotation (columns = camera axes) + position, matching
    ``geometry/cameras.py:camera_extrinsics_from_angles`` (dist = 1)."""
    x = math.cos(elev) * math.sin(azim)
    y = math.sin(elev)
    z = math.cos(elev) * math.cos(azim)
    cam_dir = np.array([x, y, z])
    loc = cam_dir.copy()
    up = np.array([0.0, 1.0, 0.0])
    z_axis = cam_dir / np.linalg.norm(cam_dir)
    x_axis = np.cross(up, z_axis)
    x_axis /= max(np.linalg.norm(x_axis), 1e-5)
    y_axis = np.cross(z_axis, x_axis)
    y_axis /= max(np.linalg.norm(y_axis), 1e-5)
    r = np.stack([x_axis, y_axis, z_axis], axis=1)  # columns
    return r, loc


def render_head(
    rng: np.random.Generator,
    res: int,
    azim_range: float = 0.3,
    elev_range: float = 0.15,
    uniform: bool = False,
    flat_bg: float | None = None,
) -> np.ndarray:
    """One identity, one pose -> [res, res, 3] float in [0, 1].

    ``uniform`` draws azim/elev ~ U(-range, range) instead of N(0, range) —
    the wide-pose (CARLA-style) regime.  ``flat_bg`` replaces the random
    background gradient with a constant gray level — pair it with the
    renderer's fixed-background mode (``RendererConfig.bg_mode``), under
    which only real density can produce non-background pixels and the
    far-plane billboard collapse is structurally impossible.
    """
    # --- identity ---------------------------------------------------------
    axes = np.array([
        rng.uniform(0.055, 0.07),   # x: head half-width
        rng.uniform(0.07, 0.09),    # y: head half-height
        rng.uniform(0.055, 0.075),  # z: depth
    ])
    skin = rng.uniform([0.55, 0.35, 0.25], [0.95, 0.75, 0.6])
    hair = rng.uniform([0.05, 0.03, 0.02], [0.5, 0.35, 0.25])
    if flat_bg is None:
        bg_top = rng.uniform(0.1, 0.9, 3)
        bg_bot = np.clip(bg_top + rng.uniform(-0.3, 0.3, 3), 0.0, 1.0)
    else:
        bg_top = bg_bot = np.full(3, flat_bg)
    eye_x = rng.uniform(0.30, 0.45)      # lateral eye offset (unit-sphere space)
    eye_y = rng.uniform(0.15, 0.3)       # eye height
    hair_y = rng.uniform(0.45, 0.6)      # hair cap starts above this y
    mouth_w = rng.uniform(0.25, 0.45)

    # --- pose (matches generate_camera_params with the same flags) --------
    if uniform:
        azim = float(rng.uniform(-azim_range, azim_range))
        elev = float(rng.uniform(-elev_range, elev_range))
    else:
        azim = float(rng.normal(0.0, azim_range))
        elev = float(rng.normal(0.0, elev_range))
    r, cam_loc = _look_at(azim, elev)

    focal = 0.5 * res / math.tan(6.0 * math.pi / 180.0)
    jj, ii = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    # pixel -> camera-space direction (y down the image, camera looks +z)
    dirs_cam = np.stack(
        [
            (ii - res / 2 + 0.5) / focal,
            -(jj - res / 2 + 0.5) / focal,
            -np.ones_like(ii, dtype=np.float64),
        ],
        axis=-1,
    )
    dirs = dirs_cam @ r.T  # camera axes are columns of r; camera looks -z_axis
    # camera looks AT the origin from cam_loc = +z_axis, so -z_cam is correct
    origins = cam_loc[None, None, :]

    # --- ray/ellipsoid intersection in unit-sphere space -------------------
    o = origins / axes
    d = dirs / axes
    a = np.sum(d * d, axis=-1)
    b = 2.0 * np.sum(o * d, axis=-1)
    c = float(np.sum(o * o)) - 1.0
    disc = b * b - 4 * a * c
    hit = disc > 0
    sq = np.sqrt(np.maximum(disc, 0.0))
    t = (-b - sq) / (2 * a)
    hit &= t > 0

    p_world = origins + t[..., None] * dirs          # [R, R, 3]
    p_unit = p_world / axes                          # on the unit sphere
    normal = p_unit / axes
    normal /= np.maximum(np.linalg.norm(normal, axis=-1, keepdims=True), 1e-9)

    # --- object-space albedo features --------------------------------------
    albedo = np.broadcast_to(skin, p_unit.shape).copy()
    is_hair = p_unit[..., 1] > hair_y
    # hair also wraps the back of the head (z < -0.2 in object space)
    is_hair |= (p_unit[..., 2] < -0.25) & (p_unit[..., 1] > -0.2)
    albedo[is_hair] = hair
    dark = np.array([0.05, 0.04, 0.05])
    for sx in (-1.0, 1.0):
        eye = np.array([sx * eye_x, eye_y, math.sqrt(
            max(1e-6, 1.0 - (eye_x ** 2 + eye_y ** 2)))])
        w = np.exp(-np.sum((p_unit - eye) ** 2, axis=-1) / (2 * 0.006))
        albedo = albedo * (1 - w[..., None]) + dark * w[..., None]
    mouth = np.array([0.6, 0.15, 0.15])
    wm = (np.exp(-(p_unit[..., 1] + 0.38) ** 2 / (2 * 0.002))
          * (np.abs(p_unit[..., 0]) < mouth_w) * (p_unit[..., 2] > 0.5))
    albedo = albedo * (1 - wm[..., None]) + mouth * wm[..., None]

    # --- shade --------------------------------------------------------------
    light = np.array([0.4, 0.7, 0.6])
    light /= np.linalg.norm(light)
    lambert = np.maximum(np.sum(normal * light, axis=-1), 0.0)
    shaded = albedo * (0.35 + 0.75 * lambert[..., None])

    frac = (jj / (res - 1))[..., None]
    img = bg_top * (1 - frac) + bg_bot * frac
    img = np.where(hit[..., None], shaded, img)
    return np.clip(img, 0.0, 1.0)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Render procedural heads into a record store.")
    p.add_argument("--out", type=str, default="data/synthetic")
    p.add_argument("--png_dir", type=str, default=None,
                   help="where to keep the intermediate PNGs (default <out>_png)")
    p.add_argument("--n", type=int, default=4000)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--azim", type=float, default=0.3)
    p.add_argument("--elev", type=float, default=0.15)
    p.add_argument("--uniform", action="store_true",
                   help="azim/elev ~ U(-range, range) instead of N(0, range)")
    p.add_argument("--flat_bg", type=float, default=None,
                   help="constant background gray level in [0,1] (for "
                        "bg_mode-fixed training) instead of random gradients")
    args = p.parse_args(argv)

    from .png import encode_png
    from .prepare import prepare_data

    png_dir = args.png_dir or args.out.rstrip("/") + "_png"
    os.makedirs(png_dir, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    for i in range(args.n):
        img = render_head(rng, args.res, azim_range=args.azim, elev_range=args.elev,
                          uniform=args.uniform, flat_bg=args.flat_bg)
        with open(os.path.join(png_dir, f"{i:06d}.png"), "wb") as f:
            f.write(encode_png((img * 255).astype(np.uint8)))
        if (i + 1) % 500 == 0:
            print(f"rendered {i + 1}/{args.n}", flush=True)

    n = prepare_data(png_dir, args.out, sizes=(args.res,), n_workers=1)
    print(f"record store: {n} images @ {args.res}^2 -> {args.out}")


if __name__ == "__main__":
    main()
