#!/usr/bin/env python
"""Make the GIRAFFE bridge fixture: a tiny GIRAFFE run trained by the JAX
package, exported for the PyTorch port, with JAX's images of it.

    python scripts/make_jax_giraffe_fixture.py

Run once where JAX, orbax and PIL are installed; it writes
``tests/fixtures/jax_giraffe_run/``:

* ``run/{model,model_0000004}.npz``: 4 iterations of the JAX ``train.py
  --sdf 0 --i_embed 1 --log2_hashmap_size 10 --finest_res 64``
  (``train_giraffe``) from ``jax_giraffe.yaml`` over the committed image
  fixtures (``tests/fixtures/images/``), ``checkpoint_every`` and
  ``backup_every`` 2, each archive written by
  ``scripts/export_jax_checkpoint.py``; the older backup
  ``model_0000002`` is left out (the same kind of tree, 460 KB).  No VAE:
  at 32^2 its fc alone has 4M parameters;
* ``samples.npz``: JAX's ``giraffe_forward`` images of ``model``'s
  ``g_ema`` (eval mode) for fixed codes (``z_*``), a sampled camera
  (``camera_mat``, ``world_mat``), box transforms (``s``, ``t``, ``r``) and
  a background rotation (``bg_rotation``), and the frames of the
  ``object_rotation`` program (``rotation_frames`` [steps, B, H, W, 3]) for
  those codes.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "jax_giraffe_run")
CONFIG = os.path.join(FIXTURE, "jax_giraffe.yaml")
FLAGS = ["--sdf", "0", "--i_embed", "1", "--log2_hashmap_size", "10", "--finest_res", "64"]
N_IMAGES, ROTATION_STEPS, BG_ROTATION = 2, 3, 0.1


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from export_jax_checkpoint import export_run

    import train as jax_train
    from sdface_gan_tpu.config import load_config
    from sdface_gan_tpu.config.yaml_config import default_config_path
    from sdface_gan_tpu.giraffe.bbox import sample_transformations
    from sdface_gan_tpu.giraffe.camera import get_rotation_matrix
    from sdface_gan_tpu.giraffe.config import giraffe_config_from_yaml
    from sdface_gan_tpu.giraffe.generator import (
        giraffe_forward,
        sample_latent_codes,
        sample_random_camera,
    )
    from sdface_gan_tpu.giraffe.rendering import render_program
    from sdface_gan_tpu.utils.checkpoints import load_checkpoint

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as td:
        os.symlink(os.path.join(REPO, "tests"), os.path.join(td, "tests"))
        os.chdir(td)
        try:
            args = jax_train.parse_args(["--config", CONFIG, *FLAGS])
            cfg = load_config(CONFIG, default_config_path())
            jax_train.train_giraffe_family(args, cfg)
            run = os.path.join(td, cfg["training"]["out_dir"])
            shutil.rmtree(os.path.join(FIXTURE, "run"), ignore_errors=True)
            export_run(run, os.path.join(FIXTURE, "run"))
            os.remove(os.path.join(FIXTURE, "run", "model_0000002.npz"))

            gcfg = giraffe_config_from_yaml(cfg, args)
            g_ema = load_checkpoint(run, "model")["g_ema"]
            codes = sample_latent_codes(jax.random.PRNGKey(11), gcfg, N_IMAGES, tmp=0.65)
            cams = sample_random_camera(jax.random.PRNGKey(12), gcfg, N_IMAGES)
            trans = sample_transformations(jax.random.PRNGKey(13), gcfg.bbox, N_IMAGES)
            bg = get_rotation_matrix(BG_ROTATION, N_IMAGES)
            images = giraffe_forward(g_ema, gcfg, latent_codes=codes, camera_matrices=cams,
                                     transformations=trans, bg_rotation=bg, mode="eval")
            frames = render_program(g_ema, gcfg, "object_rotation", os.path.join(td, "r"),
                                    n_samples=N_IMAGES, n_steps=ROTATION_STEPS, codes=codes,
                                    save_video=False)
        finally:
            os.chdir(cwd)
    np.savez(os.path.join(FIXTURE, "samples.npz"),
             **{k: np.asarray(v) for k, v in codes._asdict().items()},
             camera_mat=np.asarray(cams[0]), world_mat=np.asarray(cams[1]),
             s=np.asarray(trans[0]), t=np.asarray(trans[1]), r=np.asarray(trans[2]),
             bg_rotation=np.asarray(bg), images=np.asarray(images),
             rotation_frames=np.stack(frames))
    for root, _, names in sorted(os.walk(FIXTURE)):
        for n in sorted(names):
            path = os.path.join(root, n)
            print(f"{os.path.relpath(path, REPO)}  {os.path.getsize(path)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
