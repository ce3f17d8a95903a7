"""Import a run of the JAX package into the port's checkpoints.

    python scripts/export_jax_checkpoint.py out/<exp> <dst>      # where JAX is
    python -m sdface_gan_tpu_torch.import_jax_checkpoints --src <dst> \\
        --config configs/256res/ffhq_256_sdf.yaml --sdf 1
    python -m sdface_gan_tpu_torch.import_jax_checkpoints --src <dst> \\
        --config configs/256res/ffhq_256.yaml --sdf 0 [--i_embed 1 | --small_net 1]

The first command (the JAX side) writes one numpy archive per orbax
checkpoint of the run; this one writes the port's ``.pt`` checkpoint for
each under the same name, and refuses to overwrite one that exists.  The
model-defining flags are those of the port's train entry and must be the
ones the JAX run was trained with.

``--sdf 1`` (``--ngp``, ``--fc``): an SDF run, into ``./out/<exp>``
(``<exp>`` from the yaml's ``training.out_dir``), where the port's
``train`` looks.  Then ``python -m sdface_gan_tpu_torch.train`` with the
same flags resumes the newest ``models_*`` at its step + 1 (or skips a
stage whose artifact exists), and ``SDFaceSampler.from_checkpoint``,
``eval``, ``sdf_mesh`` and ``probe_geometry`` read the artifacts.
Parameters and optimizer states cross exactly; after a resume the
randomness is the port's own (JAX's and torch's random streams never
match), so a resumed run takes steps of the same kind on other draws.

``--sdf 0`` (``--i_embed``, ``--small_net``, ``--finest_res``,
``--log2_hashmap_size``): a GIRAFFE run's ``CheckpointIO`` trees
(``model``: ``g``, ``d``, ``g_ema``, the RMSprop or Adam states ``g_opt``
and ``d_opt``, ``it``, ``fid_best``; ``model_best`` and ``model_<it>``;
``encoder``: the VAE's ``e`` and its Adam state ``e_opt``), or a gan2d
run's ``model`` (the yaml's ``method: gan2d``), into the yaml's
``training.out_dir``.  There ``python -m sdface_gan_tpu_torch.train --sdf
0`` with the same flags resumes it at ``it`` + 1, and ``... .render`` and
``... .extract_mesh`` read a GIRAFFE run.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    from .giraffe.config import add_giraffe_flags

    p = argparse.ArgumentParser(description="Import an exported JAX run into the port.")
    p.add_argument("--src", required=True,
                   help="the archives of scripts/export_jax_checkpoint.py")
    p.add_argument("--config", type=str, default="configs/256res/ffhq_256_sdf.yaml")
    p.add_argument("--sdf", type=int, default=0)
    p.add_argument("--ngp", type=int, default=0)
    p.add_argument("--fc", type=int, default=0)
    add_giraffe_flags(p)
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    from .config import load_config
    from .config.yaml_config import default_config_path
    from .utils.checkpoints import import_jax_run

    cfg = load_config(args.config, default_config_path())
    if args.sdf == 1:
        configs, out_base = sdf_run_configs(cfg, args)
    elif cfg.get("method", "giraffe") == "gan2d":
        from .gan2d.train_loop import gan2d_run_configs

        configs, out_base = gan2d_run_configs(cfg), cfg["training"]["out_dir"]
    else:
        from .giraffe.train_loop import giraffe_run_configs

        configs, out_base = giraffe_run_configs(cfg, args), cfg["training"]["out_dir"]
    for path in import_jax_run(args.src, out_base, configs):
        print(f"wrote {path}")


def sdf_run_configs(cfg, args):
    """(RunConfigs, output directory) of an SDF run, as ``train`` builds them."""
    from .train import stage_configs
    from .training.encoder_loop import encoder_config
    from .utils.checkpoints import RunConfigs

    flags = dict(ngp=bool(args.ngp), fc=bool(args.fc))
    stage_b = stage_configs(cfg, False, **flags)
    img_size = cfg["data"].get("img_size", 256)
    configs = RunConfigs(stage_a=stage_configs(cfg, True, **flags), stage_b=stage_b,
                         vae=encoder_config(stage_b[0], img_size, psp=False),
                         psp=encoder_config(stage_b[0], img_size, psp=True))
    return configs, os.path.join("./out", cfg["training"]["out_dir"].split("/")[1])


if __name__ == "__main__":
    main()
