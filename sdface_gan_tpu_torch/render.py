"""Render CLI of the GIRAFFE family, port of the repository's ``render.py``:
load a trained generator and run the yaml's ``rendering.render_program``
list, with the JAX CLI's flags plus the GIRAFFE model flags of ``train``
(``--small_net``, ``--i_embed``, ``--finest_res``, ``--log2_hashmap_size``)
and ``--device``.

    python -m sdface_gan_tpu_torch.render --config configs/256res/ffhq_256.yaml

The generator is ``g_ema`` of ``<training.out_dir>/model_best.pt``, else of
``model.pt`` (``import_jax_checkpoints --sdf 0`` writes them from a JAX
run); the frames go to ``<training.out_dir>/<rendering.render_dir>/`` as
one PNG sheet per program (no ``.mp4``: the port has no video encoder).
``--vae 1`` encodes real images (``--vae_images``, default the yaml's data
path) with the VAE of ``encoder.pt``, preprocessed as the encoder was
trained, and renders the programs with their codes ([z_shape | z_app],
the background's codes drawn at 0.65).  Runs on ``--device cuda`` (the
default; raises without a card) or ``cpu``, f32 without TF32.
"""

from __future__ import annotations

import argparse
import os


def add_model_flags(p: argparse.ArgumentParser) -> None:
    """The GIRAFFE model flags and ``--device``."""
    from .giraffe.config import add_giraffe_flags

    add_giraffe_flags(p)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Render a GIRAFFE model.")
    p.add_argument("--config", type=str, default="configs/256res/ffhq_256.yaml")
    p.add_argument("--n_samples", type=int, default=4)
    p.add_argument("--n_steps", type=int, default=16)
    p.add_argument("--vae", type=int, default=0,
                   help="condition render programs on VAE-encoded real images")
    p.add_argument("--vae_images", type=str, default=None,
                   help="image dir/glob for --vae (default: the yaml data path)")
    p.add_argument("--export_meshes", type=int, default=0,
                   help="write per-identity .ply meshes during object_rotation")
    p.add_argument("--mesh_res", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    add_model_flags(p)
    return p.parse_args(argv)


def load_trained(args):
    """(yaml, GiraffeConfig, g_ema in eval mode on the device, its
    CheckpointIO, device) for the flags."""
    import torch

    from .config import load_config
    from .config.yaml_config import default_config_path
    from .giraffe.config import giraffe_config_from_yaml
    from .giraffe.generator import GiraffeGenerator
    from .utils.checkpoints import CheckpointIO
    from .utils.device import disable_tf32, resolve_device

    device = resolve_device(args.device)
    disable_tf32()
    cfg = load_config(args.config, default_config_path())
    gcfg = giraffe_config_from_yaml(cfg, args)
    ckpt = CheckpointIO(cfg["training"]["out_dir"])
    name = "model_best" if ckpt.exists("model_best") else "model"
    g = GiraffeGenerator(gcfg)
    g.load_state_dict(ckpt.load(name, map_location="cpu")["g_ema"])
    return cfg, gcfg, g.to(device).eval(), ckpt, device


def main(argv=None) -> None:
    args = parse_args(argv)

    import torch

    from .giraffe.rendering import render_program

    cfg, gcfg, g, ckpt, device = load_trained(args)
    render_dir = os.path.join(cfg["training"]["out_dir"],
                              cfg["rendering"].get("render_dir", "rendering"))
    codes = encode_real_images(args, cfg, gcfg, ckpt, device) if args.vae else None
    for program in cfg["rendering"].get("render_program", ["object_rotation"]):
        print(f"rendering program: {program}")
        render_program(g, gcfg, program, render_dir, n_samples=args.n_samples,
                       n_steps=args.n_steps, codes=codes,
                       generator=torch.Generator().manual_seed(args.seed),
                       export_meshes=bool(args.export_meshes) and program == "object_rotation",
                       mesh_resolution=args.mesh_res)


def encode_real_images(args, cfg, gcfg, ckpt, device):
    """Object codes of ``n_samples`` real images: the VAE's reparameterised
    latent split into [z_shape | z_app] and tiled over the boxes; the
    background's codes drawn at 0.65 (draws: eps, then the two codes)."""
    import numpy as np
    import torch

    from .data.images import ImagesDataset
    from .encoder.vae import VAEEncoder, VAEEncoderConfig, reparameterize
    from .giraffe.generator import LatentCodes

    img_size = cfg["data"].get("img_size", 64)
    if not ckpt.exists("encoder"):
        raise SystemExit("--vae requires a trained encoder checkpoint "
                         "(encoder.pt beside the model's)")
    e = VAEEncoder(VAEEncoderConfig(img_size=img_size, z_size=2 * gcfg.z_dim))
    e.load_state_dict(ckpt.load("encoder", map_location="cpu")["e"])
    e = e.to(device).eval()

    pattern = args.vae_images or cfg["data"]["path"]
    if os.path.isdir(pattern):
        pattern = os.path.join(pattern, "*")
    # preprocessed as the encoder was trained (crop, range from the yaml)
    dataset = ImagesDataset(pattern, size=img_size,
                            celebA_center_crop=cfg["data"].get("celebA_center_crop", False),
                            random_crop=cfg["data"].get("random_crop", False),
                            use_tanh_range=cfg["data"].get("use_tanh_range", False),
                            hflip=False)
    n_cond = min(args.n_samples, len(dataset))
    imgs = np.stack([dataset[i] for i in range(n_cond)])
    print(f"conditioning on {n_cond} real images from {pattern}")

    gen = torch.Generator().manual_seed(args.seed)
    with torch.no_grad():
        mu, logvar = e(torch.from_numpy(imgs).to(device))
    z = reparameterize(mu, logvar, torch.randn(mu.shape, generator=gen).to(device))
    n = z.shape[0]
    z_shape = z[:, None, :gcfg.z_dim].repeat(1, gcfg.n_boxes, 1)
    z_app = z[:, None, gcfg.z_dim:].repeat(1, gcfg.n_boxes, 1)
    bg = [0.65 * torch.randn((n, gcfg.z_dim_bg), generator=gen).to(device) for _ in range(2)]
    return LatentCodes(z_shape, z_app, *bg)


if __name__ == "__main__":
    main()
