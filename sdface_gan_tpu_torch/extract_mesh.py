"""Mesh CLI of the GIRAFFE family, port of the repository's ``extract_mesh.py``:
object 0's density on a grid over its box, as alpha, through marching
cubes, one ``<training.out_dir>/meshes/mesh_{i:03d}.ply`` per sampled
code (seed 0, temperature 0.65).  The JAX CLI's flags, plus ``render``'s
GIRAFFE model flags and ``--device``.

    python -m sdface_gan_tpu_torch.extract_mesh --config configs/256res/ffhq_256.yaml
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    from .render import add_model_flags

    p = argparse.ArgumentParser(description="Extract GIRAFFE meshes.")
    p.add_argument("--config", type=str, default="configs/256res/ffhq_256.yaml")
    p.add_argument("--n_meshes", type=int, default=4)
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--level", type=float, default=0.005)
    add_model_flags(p)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    import torch

    from .giraffe.generator import sample_latent_codes
    from .giraffe.rendering import CODE_TMP, extract_giraffe_mesh
    from .render import load_trained

    cfg, gcfg, g, _, device = load_trained(args)
    mesh_dir = os.path.join(cfg["training"]["out_dir"], "meshes")
    os.makedirs(mesh_dir, exist_ok=True)
    gen = torch.Generator().manual_seed(0)
    for i in range(args.n_meshes):
        codes = sample_latent_codes(gen, gcfg, 1, tmp=CODE_TMP, device=device)
        mesh = extract_giraffe_mesh(g, gcfg, codes, resolution=args.resolution,
                                    level=args.level)
        path = os.path.join(mesh_dir, f"mesh_{i:03d}.ply")
        mesh.export_ply(path)
        print(f"{path}: {len(mesh.verts)} verts, {len(mesh.faces)} faces")


if __name__ == "__main__":
    main()
