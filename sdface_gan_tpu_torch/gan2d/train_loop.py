"""gan2d training loop, port of ``sdface_gan_tpu/gan2d/train_loop.py``:
GIRAFFE's loop shape over the 2D generator, reading what JAX's
``train_gan2d`` reads (``model.z_dim``; ``training.batch_size``,
``learning_rate``, ``learning_rate_d``, ``out_dir``, ``print_every``,
``visualize_every``, ``checkpoint_every``, ``max_it``; the DC
discriminator at its default width), with RMSprop always.  Checkpoint
``model`` {g, d, g_ema, g_opt, d_opt, it} under ``training.out_dir``;
``--exit-after`` saves it and exits with code 3."""

from __future__ import annotations

import copy
import os
import time
from typing import Any

import torch

from ..giraffe.discriminator import DCDiscConfig, DCDiscriminator
from ..giraffe.train_loop import VIS_N, VIS_SEED, images_loader
from ..training.optim import giraffe_optimizers
from ..utils.checkpoints import CheckpointIO, GiraffeRunConfigs
from ..utils.images import save_image_grid
from ..utils.logging import MetricsLogger
from .generator import Gan2dGenerator, Gan2dGeneratorConfig
from .trainer import Gan2dTrainHParams, gan2d_d_step, gan2d_g_step, sample_z


def gan2d_run_configs(cfg: Any) -> GiraffeRunConfigs:
    """The generator, discriminator and trainer configs of a loaded yaml."""
    tr = cfg["training"]
    img_size = cfg["data"].get("img_size", 64)
    gcfg = Gan2dGeneratorConfig(z_dim=cfg.get("model", {}).get("z_dim", 256), size=img_size)
    hp = Gan2dTrainHParams(batch_size=tr.get("batch_size", 32),
                           lr_g=tr.get("learning_rate", 0.0005),
                           lr_d=tr.get("learning_rate_d", 0.0001))
    return GiraffeRunConfigs(gcfg, DCDiscConfig(img_size=img_size), hp)


def train_gan2d(args: Any, cfg: Any, device: torch.device) -> None:
    """Train gan2d from a loaded yaml and the train entry's ``--seed`` and
    ``--exit-after`` on ``device``."""
    gcfg, dcfg, hp, _ = gan2d_run_configs(cfg)
    tr = cfg["training"]
    out_dir = tr.get("out_dir", "out/gan2d")
    print_every = tr.get("print_every", 10)
    loader = iter(images_loader(cfg, hp.batch_size, args.seed))  # no image: nothing written
    logger = MetricsLogger(out_dir, "gan2d", print_every=print_every)

    gen = torch.Generator().manual_seed(args.seed)
    g = Gan2dGenerator(gcfg, gen).to(device)
    d = DCDiscriminator(dcfg, gen).to(device)
    g_ema = copy.deepcopy(g)
    g_opt, d_opt = giraffe_optimizers(hp, g, d)

    ckpt = CheckpointIO(out_dir)
    it = 0
    if ckpt.exists("model"):
        state = ckpt.load("model", map_location=device)
        for module, key in ((g, "g"), (d, "d"), (g_ema, "g_ema"), (g_opt, "g_opt"),
                            (d_opt, "d_opt")):
            module.load_state_dict(state[key])
        it = int(state["it"])

    def save_model():
        ckpt.save("model", g=g.state_dict(), d=d.state_dict(), g_ema=g_ema.state_dict(),
                  g_opt=g_opt.state_dict(), d_opt=d_opt.state_dict(), it=it)

    max_it = tr.get("max_it", 1000000)
    exit_after = getattr(args, "exit_after", -1)
    t0 = time.time()
    while it < max_it:
        it += 1
        x_real = torch.from_numpy(next(loader)).to(device)
        dm = gan2d_d_step(g, d, d_opt, hp, x_real, sample_z(gen, hp.batch_size, gcfg.z_dim, device))
        gm = gan2d_g_step(g, d, g_opt, g_ema, hp, sample_z(gen, hp.batch_size, gcfg.z_dim, device))
        if it % print_every == 0:
            logger.log(it, {**dm, **gm})
        if it % tr.get("visualize_every", 1000) == 0:
            z = sample_z(torch.Generator().manual_seed(VIS_SEED), VIS_N, gcfg.z_dim, device)
            with torch.no_grad():
                imgs = g_ema(z)
            save_image_grid(imgs.cpu().numpy(), os.path.join(out_dir, f"vis_{it:07d}.png"), nrow=4)
        if it % tr.get("checkpoint_every", 500) == 0:
            save_model()
        if exit_after and exit_after > 0 and time.time() - t0 > exit_after:
            save_model()
            raise SystemExit(3)
    logger.close()
