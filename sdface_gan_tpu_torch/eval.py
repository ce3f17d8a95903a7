"""Evaluation CLI of the port: the repository's ``eval.py`` protocol (FID and
KID of the full-pipeline EMA generator), with the same flags plus
``--device``.

    python -m sdface_gan_tpu_torch.eval --config configs/256res/ffhq_256_sdf.yaml \\
        --n_images 5000 --real_dir <store or image dir>

Protocol (reference ``eval.py:87-167`` + ``README.md:44-53``): load
``out/<exp>/full_pipeline.pt``'s ``g_ema``, sample N identities (one random
camera each, truncation 1, random decoder noise), dump PNGs to
``out/<exp>/eval/``, then score FID (and KID) against a precomputed stats
``.npz`` or a directory / record store of real images.  ``--no_dump``
feeds each generated batch straight into the Inception on the card; only
[batch, 2048] activations reach the host.

The SIREN field runs through the port's fused kernel (``siren_field_f32_kernel``
with ``--g_dtype float32``, ``siren_field_mma_kernel`` with ``bfloat16``),
the NGP field through ``hash_encode`` and ``table_gather``.  TF32 is off.
Under the launcher (``python -m torch.distributed.run``) sampling is
data-parallel, as the JAX version's mesh: each global batch (the world must
divide ``--batch``) is drawn whole and split over the ranks, each rank
renders and scores its rows, the images and Inception activations are
gathered, and rank 0 dumps the PNGs and scores FID and KID once.
Without weights (``--inception_weights``) the Inception is a random init,
so its FID is not comparable with published ones.
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import replace
from typing import Optional

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate an SDFace-GAN model with the PyTorch port.")
    p.add_argument("--config", type=str, default="configs/256res/ffhq_256_sdf.yaml")
    p.add_argument("--sdf", type=int, default=1)
    p.add_argument("--ngp", type=int, default=0)
    p.add_argument("--fc", type=int, default=0)
    p.add_argument("--n_images", type=int, default=5000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--fid_file", type=str, default=None,
                   help=".npz with precomputed (mu, sigma) real stats")
    p.add_argument("--real_dir", type=str, default=None,
                   help="record store or directory of real images (PNG, JPEG, BMP) to score against")
    p.add_argument("--inception_weights", type=str, default=None,
                   help="pytorch-fid inception checkpoint for exact parity")
    p.add_argument("--no_fid", action="store_true")
    p.add_argument("--g_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="generation precision: bfloat16 casts the EMA weights like "
                        "the serving path (tensor-core field kernel; compositing "
                        "stays f32)")
    p.add_argument("--no_dump", action="store_true",
                   help="skip the PNG dump and feed each generated batch straight "
                        "into the Inception on the card (FID-only scoring)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def eval_generator_config(gcfg):
    """The config generation runs with: the fused SIREN field (the kernel
    on a CUDA tensor) for the 'sdf' type; NGP takes its hash-grid kernels
    on a CUDA tensor whatever this flag says."""
    if gcfg.renderer.type == "sdf":
        gcfg = replace(gcfg, renderer=replace(gcfg.renderer, use_fused_kernel=True))
    return gcfg


def sample_images(model, gcfg, z, cams, generator: Optional[torch.Generator] = None,
                  field_pack=None) -> torch.Tensor:
    """Images [B, size, size, 3] f32 on the model's device.  ``generator``
    draws the depth jitter and the decoder noise (None: fixed depths and
    the stored noise, the deterministic mode the tests compare)."""
    from .models.generator import generator_forward

    out = generator_forward(model, gcfg, [z], cams.extrinsics, cams.focal, cams.near,
                            cams.far, generator=generator, field_pack=field_pack)
    # images leave f32 whatever --g_dtype (PNG encode and Inception expect it)
    return out.rgb.float()


def main(argv=None) -> dict:
    """Run the protocol; returns what it measured (``n_images``,
    ``seconds``, ``seconds_first_batch``, and ``fid`` / ``kid_mean`` /
    ``kid_std`` where scored; rank 0's, over several ranks)."""
    args = parse_args(argv)

    from .parallel import close, make_mesh
    from .utils.device import resolve_device

    mesh = make_mesh(resolve_device(args.device))
    try:
        return _evaluate(args, mesh)
    finally:
        close(mesh)


def _evaluate(args, mesh) -> dict:
    import numpy as np

    from .config import load_config
    from .config.build import generator_config
    from .config.sdf_options import get_vol_render_opt, rendering_overrides, resolve_renderer_type
    from .config.yaml_config import default_config_path
    from .geometry import generate_camera_params
    from .models.generator import pack_generator_for_inference
    from .ops.siren_kernel import pack_siren_field
    from .parallel import gather_rows, over, shard_batch
    from .utils.checkpoints import load_generator
    from .utils.device import disable_tf32
    from .utils.images import to_uint8, write_png

    device = mesh.device
    if args.batch % mesh.world:
        raise ValueError(f"batch {args.batch} must divide the {mesh.world}-rank world")
    disable_tf32()
    cfg = load_config(args.config, default_config_path())
    expname = cfg["training"]["out_dir"].split("/")[1]
    out_base = os.path.join("./out", expname)
    eval_dir = os.path.join(out_base, "eval")
    os.makedirs(eval_dir, exist_ok=True)

    img_size = cfg["data"].get("img_size", 256)
    opt = get_vol_render_opt(expname, False, ngp=resolve_renderer_type(cfg, bool(args.ngp)),
                             fc=bool(args.fc), size=img_size, batch=args.batch,
                             extra_argv=rendering_overrides(cfg))
    gcfg = eval_generator_config(generator_config(opt, stage_a=False))

    # Resolve the real-stats source up front: with --no_dump and no FID
    # source the whole generation pass would produce nothing; an image
    # directory the port cannot read raises here too.
    from .evaluation.real import is_record_store, list_image_files

    fid_file = args.fid_file or cfg["data"].get("fid_file")
    if fid_file and not os.path.exists(fid_file):
        print(f"fid_file {fid_file!r} not found; falling back to --real_dir")
        fid_file = None
    if args.no_dump and not args.no_fid and not fid_file and not args.real_dir:
        raise SystemExit(
            "--no_dump produces no PNGs, and no real-stats source is "
            "available to score against — pass --fid_file or --real_dir "
            "(or drop --no_dump to keep the image dump)"
        )
    real_store = real_names = None
    if not args.no_fid and not fid_file and args.real_dir:
        real_store = is_record_store(args.real_dir)
        if real_store is None:
            real_names = list_image_files(args.real_dir, args.n_images)

    model = load_generator(out_base, "full_pipeline", gcfg, device=device)
    if args.g_dtype != "float32":
        # the serving cast: bf16 weights, f32 compositing inside the renderer
        model = model.to(getattr(torch, args.g_dtype))
    pack_generator_for_inference(model)
    field_pack = (pack_siren_field(model.renderer.network)
                  if gcfg.renderer.use_fused_kernel else None)
    res = gcfg.renderer.out_im_res

    inc = None
    if not args.no_fid:
        from .evaluation import load_inception

        inc = load_inception(args.inception_weights, device=device)

    stats = {"n_images": 0, "seconds": 0.0, "seconds_first_batch": 0.0}
    gen = torch.Generator(device=device).manual_seed(0)

    def generated_batches(score_on_device: bool):
        """Generate (and dump) each batch; yields the images, or their pool3
        activations on the host when ``score_on_device``."""
        t0 = time.perf_counter()
        n_done = 0
        while n_done < args.n_images:
            b = min(args.batch, args.n_images - n_done)
            with torch.inference_mode():
                z = torch.randn((args.batch, gcfg.style_dim), generator=gen, device=device)
                cams = generate_camera_params(res, gen, batch=args.batch, device=device)
                z, cams = shard_batch((z, cams), mesh)
                with over(mesh):
                    imgs = sample_images(model, gcfg, z, cams, generator=gen,
                                         field_pack=field_pack)
                if mesh.distributed:  # each rank scores its rows; both are gathered
                    out = (gather_rows(inc(imgs), mesh)[:b].cpu().numpy() if score_on_device
                           else None)
                    imgs = gather_rows(imgs, mesh)[:b]
                else:
                    imgs = imgs[:b]
                    out = inc(imgs).cpu().numpy() if score_on_device else imgs
            if not args.no_dump and (not score_on_device or mesh.distributed):
                if mesh.is_main:  # honor --no_dump on the --no_fid path too
                    for i, img in enumerate(to_uint8(imgs.cpu().numpy())):
                        write_png(os.path.join(eval_dir, f"{n_done + i:07d}.png"), img)
            elif not score_on_device and device.type == "cuda":
                torch.cuda.synchronize(device)
            n_done += b
            stats["n_images"], stats["seconds"] = n_done, time.perf_counter() - t0
            if n_done == b:
                stats["seconds_first_batch"] = stats["seconds"]
            yield out

    if args.no_fid:
        for _ in generated_batches(False):
            pass
        print(f"generated {stats['n_images']} images in {stats['seconds']:.1f}s "
              f"({stats['seconds'] / max(stats['n_images'], 1):.3f} s/image)")
        return stats

    from .evaluation import (
        calculate_activation_statistics,
        calculate_frechet_distance,
        calculate_kid,
        compute_activations,
        load_stats_npz,
    )

    if args.no_dump or mesh.distributed:
        fake_acts = np.concatenate(list(generated_batches(True)), axis=0)
        if not mesh.is_main:
            return stats
        print(f"scored {stats['n_images']} images in {stats['seconds']:.1f}s "
              f"({stats['seconds'] / max(stats['n_images'], 1):.3f} s/image, "
              f"generation + inception on the card, no image dump)")
    else:
        # streaming: each generated batch feeds the Inception at once; host
        # memory stays flat in image count (only activations persist)
        fake_acts = compute_activations(inc, generated_batches(False), batch_size=args.batch)
        print(f"generated {stats['n_images']} images in {stats['seconds']:.1f}s "
              f"({stats['seconds'] / max(stats['n_images'], 1):.3f} s/image, "
              f"incl. streaming FID)")
    mu_f, s_f = calculate_activation_statistics(fake_acts)

    if fid_file:
        mu_r, s_r = load_stats_npz(fid_file, expect_img_size=img_size)
        stats["fid"] = calculate_frechet_distance(mu_f, s_f, mu_r, s_r)
        print(f"FID: {stats['fid']:.4f}")
    elif args.real_dir:
        from .evaluation.real import dir_batches, store_batches

        if real_store is not None:
            real = store_batches(real_store, img_size, args.n_images, args.batch)
        else:
            real = dir_batches(args.real_dir, real_names, args.batch, img_size)
        real_acts = compute_activations(inc, real, batch_size=args.batch)
        mu_r, s_r = calculate_activation_statistics(real_acts)
        stats["fid"] = calculate_frechet_distance(mu_f, s_f, mu_r, s_r)
        stats["kid_mean"], stats["kid_std"] = calculate_kid(fake_acts, real_acts)
        print(f"FID: {stats['fid']:.4f}  KID: {stats['kid_mean']:.6f} +- "
              f"{stats['kid_std']:.6f}")
    else:
        # unreachable with --no_dump (the up-front source check fails fast)
        print("no real stats available (pass --fid_file or --real_dir); "
              "images dumped for external scoring")
    return stats


if __name__ == "__main__":
    main()
