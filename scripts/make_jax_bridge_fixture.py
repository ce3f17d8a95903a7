#!/usr/bin/env python
"""Make the checkpoint-bridge fixture: a tiny run trained by the JAX
package, exported for the PyTorch port, with JAX's images of it.

    python scripts/make_jax_bridge_fixture.py

Run once where JAX, orbax and PIL are installed; it writes
``tests/fixtures/jax_run/``:

* ``stage_a/volume_renderer/sdf_init_models.npz``: 2 sphere-init steps of
  the JAX package's ``train_volume_renderer``, configured from
  ``jax_bridge.yaml`` as its ``train.py --sdf 1`` configures it, so that
  the port's ``import_jax_checkpoints`` imports it from the same yaml.  The
  run goes on through 4 stage-A iterations, whose ``models_*`` and
  ``vol_renderer`` are left out: they hold the volume-render discriminator,
  whose 400-channel convolutions no config shrinks (35 MB, and 105 MB with
  its Adam moments);
* ``stage_b/{models_0000002,full_pipeline}.npz``: 4 stage-B iterations of
  ``train_full_pipeline`` (``save_every`` 2) from that ``vol_renderer``,
  with the decoder's and the StyleGAN2 discriminator's channel table at
  ``channel_base`` 16: at the yaml's 512 the discriminator alone has 14M
  parameters.  A yaml cannot set ``channel_base``, so these archives are
  imported with ``utils.checkpoints.import_jax_run`` and configs built in
  code;
* ``samples.npz``: JAX's images of the stage-B ``g_ema`` (eval mode, no
  depth jitter) for a fixed z, camera angles and truncation, with the
  truncation pair from JAX's ``mean_latent`` and ``channel_base``.

Every archive is written by ``scripts/export_jax_checkpoint.py``.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
from dataclasses import replace

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "jax_run")
CONFIG = os.path.join(FIXTURE, "jax_bridge.yaml")
CHANNEL_BASE = 16
BATCH, ITERS, SAVE_EVERY, SPHERE_INIT = 2, 4, 2, 2
N_IMAGES, AZIM, ELEV, TRUNCATION = 2, 0.2, -0.1, 0.7


def stage_configs(cfg, stage_a: bool):
    """(GeneratorConfig, discriminator config, TrainHParams) as the JAX
    ``train.py`` ``train_sdf`` builds them."""
    from sdface_gan_tpu.config.build import discriminator_configs, generator_config, train_hparams
    from sdface_gan_tpu.config.sdf_options import (
        get_vol_render_opt,
        rendering_overrides,
        resolve_renderer_type,
    )

    opt = get_vol_render_opt(cfg["training"]["out_dir"].split("/")[1], stage_a,
                             ngp=resolve_renderer_type(cfg, False), fc=False, wod=False,
                             size=cfg["data"].get("img_size", 256), batch=BATCH,
                             extra_argv=rendering_overrides(cfg))
    vrd, sd = discriminator_configs(opt)
    return generator_config(opt, stage_a=stage_a), vrd if stage_a else sd, train_hparams(opt)


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import jax.numpy as jnp
    from PIL import Image

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from export_jax_checkpoint import export_run

    from sdface_gan_tpu.config import load_config
    from sdface_gan_tpu.config.yaml_config import default_config_path
    from sdface_gan_tpu.data import DataLoader, MultiResolutionDataset
    from sdface_gan_tpu.data.prepare import prepare_data
    from sdface_gan_tpu.geometry import generate_camera_params
    from sdface_gan_tpu.models.generator import generator_forward, mean_latent
    from sdface_gan_tpu.training.loop import train_full_pipeline, train_volume_renderer
    from sdface_gan_tpu.utils.checkpoints import load_checkpoint

    cfg = load_config(CONFIG, default_config_path())
    img_size = cfg["data"]["img_size"]
    with tempfile.TemporaryDirectory() as td:
        os.makedirs(os.path.join(td, "imgs"))
        rng = np.random.default_rng(0)
        for i in range(8):
            Image.fromarray(rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)).save(
                os.path.join(td, "imgs", f"{i:03d}.png"))
        store = os.path.join(td, "store")
        prepare_data(os.path.join(td, "imgs"), store, sizes=(img_size,), n_workers=1)
        run = os.path.join(td, "out", "jax_bridge")

        gcfg_a, vrd, hp_a = stage_configs(cfg, True)
        ds = MultiResolutionDataset(store, resolution=img_size,
                                    nerf_resolution=gcfg_a.renderer.out_im_res)
        with DataLoader(ds, batch_size=BATCH, seed=0) as loader:
            train_volume_renderer(loader, gcfg_a, vrd, hp_a, os.path.join(run, "volume_renderer"),
                                  iters=ITERS, sphere_init_iters=SPHERE_INIT,
                                  save_every=SAVE_EVERY, sample_every=0, log_every=1, seed=0)
        ds.close()

        gcfg_b, sd, hp_b = stage_configs(cfg, False)
        gcfg_b, sd = replace(gcfg_b, channel_base=CHANNEL_BASE), replace(sd, channel_base=CHANNEL_BASE)
        ds = MultiResolutionDataset(store, resolution=img_size,
                                    nerf_resolution=gcfg_b.renderer.out_im_res)
        with DataLoader(ds, batch_size=BATCH, seed=0) as loader:
            train_full_pipeline(loader, gcfg_b, sd, hp_b, run,
                                vol_renderer_dir=os.path.join(run, "volume_renderer"),
                                iters=ITERS, save_every=SAVE_EVERY, sample_every=0, log_every=1,
                                seed=0)
        ds.close()

        for sub in ("stage_a", "stage_b"):
            shutil.rmtree(os.path.join(FIXTURE, sub), ignore_errors=True)
        exported = os.path.join(td, "export")
        export_run(run, exported)
        os.makedirs(os.path.join(FIXTURE, "stage_a", "volume_renderer"))
        shutil.copy(os.path.join(exported, "volume_renderer", "sdf_init_models.npz"),
                    os.path.join(FIXTURE, "stage_a", "volume_renderer"))
        os.makedirs(os.path.join(FIXTURE, "stage_b"))
        for name in sorted(os.listdir(exported)):
            if name.endswith(".npz"):
                shutil.copy(os.path.join(exported, name), os.path.join(FIXTURE, "stage_b", name))

        g_ema = load_checkpoint(run, "full_pipeline")["g_ema"]
        trunc = mean_latent(g_ema, gcfg_b, jax.random.PRNGKey(2))
        z = rng.standard_normal((N_IMAGES, gcfg_b.style_dim)).astype(np.float32)
        cams = generate_camera_params(gcfg_b.renderer.out_im_res, None,
                                      locations=jnp.asarray([[AZIM, ELEV]] * N_IMAGES,
                                                            jnp.float32))
        out = generator_forward(g_ema, gcfg_b, [jnp.asarray(z)], cams.extrinsics, cams.focal,
                                cams.near, cams.far, key=None, truncation=TRUNCATION,
                                truncation_latent=trunc, randomize_noise=False)
        np.savez(os.path.join(FIXTURE, "samples.npz"), z=z, azim=np.float32(AZIM),
                 elev=np.float32(ELEV), truncation=np.float32(TRUNCATION),
                 trunc_renderer=np.asarray(trunc[0]), trunc_decoder=np.asarray(trunc[1]),
                 images=np.asarray(out.rgb), channel_base=np.int64(CHANNEL_BASE))
    for root, _, names in sorted(os.walk(FIXTURE)):
        for n in sorted(names):
            path = os.path.join(root, n)
            print(f"{os.path.relpath(path, REPO)}  {os.path.getsize(path)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
