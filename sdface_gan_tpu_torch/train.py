"""Train CLI of the port, the repository's ``train.py`` with the same flags
plus ``--device``.

    python -m sdface_gan_tpu_torch.train --config configs/256res/ffhq_256_sdf_tpu.yaml \\
        --sdf 1 --dataset_path <store>
    python -m sdface_gan_tpu_torch.train --config configs/64res/synthetic_64_giraffe.yaml \\
        --sdf 0 [--vae 1] [--i_embed 1 | --small_net 1]

``--sdf 1`` trains the SDF family.  Stage A writes
``out/<exp>/volume_renderer/`` and is skipped when its ``vol_renderer``
exists; stage B writes ``out/<exp>/`` and is skipped when
``full_pipeline`` exists; ``--wod 1`` goes straight to stage B from stage
A's ``sdf_init_models``.  ``--vae 1`` / ``--psp 1`` then run stage C, an
inversion encoder against the frozen ``full_pipeline`` generator, into
``out/<exp>/encoder/`` / ``encoder_psp/`` (the ID and LPIPS terms with
``--irse_weights`` / ``--lpips_weights``).  A stage whose periodic
``models_*`` checkpoint exists resumes from it.  The NGP field trains by
``--ngp 1`` or by the yaml's ``rendering: type: ngp``.

``--sdf 0`` trains the family the yaml's ``method`` names, as the root
``train.py`` dispatches: GIRAFFE (the default; ``giraffe/train_loop.py``,
with the VAE encoder under ``--vae 1`` and the hash or small decoders
under ``--i_embed 1`` / ``--small_net 1``) or the gan2d baseline
(``method: gan2d``), over the yaml's image glob, into its
``training.out_dir``.  It resumes from ``model`` (and ``encoder``) there,
as it does from a JAX run imported by ``import_jax_checkpoints --sdf 0``.

``--exit-after`` seconds saves and exits with code 3.  Runs on ``--device
cuda`` (the default; raises without a card) or ``--device cpu``, with TF32
off so that f32 stays f32.

Data parallelism: under the launcher every stage and GIRAFFE run over its
ranks, rank r on ``cuda:<LOCAL_RANK>`` (NCCL), or on the CPU with
``--device cpu`` (gloo); ``--batch`` (GIRAFFE: the yaml's) is the global
batch, which the world must divide::

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m sdface_gan_tpu_torch.train --config <yaml> --sdf 1 --dataset_path <store>

gan2d has no mesh in the JAX package and refuses a world above one.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    from .giraffe.config import add_giraffe_flags

    p = argparse.ArgumentParser(description="Train an SDFace-GAN model with the PyTorch port.")
    p.add_argument("--config", type=str, default="configs/256res/ffhq_256_sdf.yaml")
    p.add_argument("--sdf", type=int, default=0)
    p.add_argument("--ngp", type=int, default=0)
    p.add_argument("--fc", type=int, default=0)
    p.add_argument("--wod", type=int, default=0)
    p.add_argument("--vae", type=int, default=0)
    p.add_argument("--psp", type=int, default=0)
    add_giraffe_flags(p)
    p.add_argument("--i_embed_views", type=int, default=0)
    p.add_argument("--exit-after", dest="exit_after", type=int, default=-1)
    p.add_argument("--dataset_path", type=str, default=None,
                   help="record-store dir (overrides the yaml data path)")
    p.add_argument("--iters", type=int, default=None,
                   help="override per-stage iteration count (for smoke runs)")
    p.add_argument("--sphere_init_iters", type=int, default=10000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_every", type=int, default=10000)
    p.add_argument("--sample_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--irse_weights", type=str, default=None,
                   help="model_ir_se50.pth for the stage-C ID loss + pSp warm start")
    p.add_argument("--lpips_weights", type=str, default=None,
                   help="torch archive {'alex': ..., 'lin': ...} for stage-C LPIPS")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    from .config import load_config
    from .config.yaml_config import default_config_path
    from .parallel import close, make_mesh
    from .utils.device import resolve_device

    cfg = load_config(args.config, default_config_path())
    # the launcher's world first: each rank's device is its own card
    mesh = make_mesh(resolve_device(args.device))
    if mesh.is_main:
        print(f"training {args.config} with seed {args.seed}", flush=True)
    try:
        if args.sdf == 1:
            train_sdf(args, cfg, mesh)
        else:
            train_giraffe_family(args, cfg, mesh)
    finally:
        close(mesh)


def train_giraffe_family(args, cfg, mesh) -> None:
    """``--sdf 0`` over ``mesh``: gan2d when the yaml's ``method`` says so,
    else GIRAFFE."""
    from .utils.device import disable_tf32

    device = mesh.device
    disable_tf32()
    if cfg.get("method", "giraffe") == "gan2d":
        from .gan2d.train_loop import train_gan2d

        if mesh.world > 1:
            raise ValueError(f"gan2d trains on one rank (no mesh in the JAX package); "
                             f"the world has {mesh.world}")
        train_gan2d(args, cfg, device)
    else:
        from .giraffe.train_loop import train_giraffe

        train_giraffe(args, cfg, device, mesh)


def stage_configs(cfg, stage_a: bool, ngp: bool = False, fc: bool = False, wod: bool = False,
                  batch: int = 8):
    """(GeneratorConfig, discriminator config, TrainHParams) of stage A
    (``stage_a``) or stage B, as this entry trains them from a loaded yaml
    and its flags."""
    from .config.build import (
        discriminator_configs,
        generator_config,
        stage_options,
        train_hparams,
    )

    opt = stage_options(cfg, stage_a, ngp=ngp, fc=fc, wod=wod, batch=batch)
    vrd_cfg, sd_cfg = discriminator_configs(opt)
    return generator_config(opt, stage_a=stage_a), vrd_cfg if stage_a else sd_cfg, train_hparams(opt)


def train_sdf(args, cfg, mesh) -> None:
    """``--sdf 1`` over ``mesh``: stages A and B, then stage C if asked."""
    from .data import DataLoader, MultiResolutionDataset, resolve_record_dir
    from .training.loop import train_full_pipeline, train_volume_renderer
    from .utils.checkpoints import checkpoint_exists
    from .utils.device import disable_tf32

    device = mesh.device
    disable_tf32()

    expname = cfg["training"]["out_dir"].split("/")[1]
    out_base = os.path.join("./out", expname)
    # stage A's periodic models_* live in their own directory, so stage B's
    # resume scan never finds a stage-A (decoder-less) checkpoint
    vr_dir = os.path.join(out_base, "volume_renderer")
    need_a = not checkpoint_exists(vr_dir, "vol_renderer")
    need_b = not checkpoint_exists(out_base, "full_pipeline")
    if args.wod:
        need_a, need_b = False, True

    exit_after = args.exit_after if args.exit_after > 0 else None
    data_path = args.dataset_path or resolve_record_dir(cfg["data"]["path"])
    img_size = cfg["data"].get("img_size", 256)
    flags = dict(ngp=bool(args.ngp), fc=bool(args.fc), wod=bool(args.wod), batch=args.batch)
    schedule = dict(exit_after=exit_after, save_every=args.save_every,
                    sample_every=args.sample_every, log_every=args.log_every,
                    seed=args.seed, device=device, mesh=mesh)
    hosts = dict(host_id=mesh.rank, num_hosts=mesh.world)  # each rank reads its rows

    if need_a:
        gcfg, vrd_cfg, hp = stage_configs(cfg, True, **flags)
        ds = MultiResolutionDataset(data_path, resolution=img_size,
                                    nerf_resolution=gcfg.renderer.out_im_res)
        try:
            with DataLoader(ds, batch_size=hp.batch, seed=args.seed, **hosts) as loader:
                train_volume_renderer(loader, gcfg, vrd_cfg, hp, vr_dir,
                                      iters=args.iters or 200001,
                                      sphere_init_iters=args.sphere_init_iters, **schedule)
        finally:
            ds.close()

    if need_b:
        gcfg, sd_cfg, hp = stage_configs(cfg, False, **flags)
        ds = MultiResolutionDataset(data_path, resolution=img_size,
                                    nerf_resolution=gcfg.renderer.out_im_res)
        try:
            with DataLoader(ds, batch_size=hp.batch, seed=args.seed, **hosts) as loader:
                train_full_pipeline(loader, gcfg, sd_cfg, hp, out_base,
                                    vol_renderer_dir=vr_dir,
                                    init_from="sdf_init_models" if args.wod else "vol_renderer",
                                    iters=args.iters or 300000, **schedule)
        finally:
            ds.close()

    if args.vae or args.psp:
        from .training.encoder_loop import train_encoder_stage

        train_encoder_stage(args, cfg, out_base, iters=args.iters or 100000, device=device,
                            mesh=mesh, exit_after=exit_after, save_every=args.save_every,
                            sample_every=args.sample_every, log_every=args.log_every)


if __name__ == "__main__":
    main()
