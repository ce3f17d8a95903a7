"""GIRAFFE training loop, port of ``sdface_gan_tpu/giraffe/train_loop.py``:
the iteration loop with the yaml's cadences (``print_every``,
``visualize_every``, ``checkpoint_every``, ``backup_every``,
``validate_every``), ``CheckpointIO`` resume, best-FID model selection and
the ``--exit-after`` save-and-exit(3) contract.

It reads exactly the ``training.*`` keys JAX's ``train_giraffe`` reads:
``batch_size``, ``learning_rate``, ``learning_rate_d``, ``optimizer``,
``out_dir``, ``print_every``, ``visualize_every``, ``checkpoint_every``,
``backup_every``, ``validate_every``, ``n_eval_images`` and ``max_it``.

Checkpoints under ``training.out_dir``: ``model`` {g, d, g_ema, g_opt,
d_opt, it, fid_best}, ``model_{it:07d}`` {g, d, g_ema, it}, ``model_best``
{g, d, g_ema, it, fid_best} when the FID improves, and with ``--vae 1``
``encoder`` {e, e_opt}.  After a resume the draws restart from the seed, as
JAX's key does.

Over a data-parallel ``mesh`` (default: the launcher's world), as JAX's loop
runs over its device mesh (``train_loop.py:136-169``): the modules and
optimizer states are replicated from rank 0, every rank reads the same
global batch and draws at the global batch (the one CPU generator, seeded
alike) and takes its rows, and the steps reduce their gradients over the
ranks.  Rank 0 alone writes checkpoints, grids and metrics (averaged over
the ranks) and scores FID, then hands its generator state to the others
(FID draws from it); the ``--exit-after`` cut is rank 0's, broadcast.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Any, Optional

import torch

from ..data.images import ImagesDataset, ImagesLoader
from ..encoder.vae import VAEEncoder
from ..parallel.mesh import Mesh, barrier, broadcast_generator, decide, replicate, shard_batch
from ..training.loop import log_metrics, training_mesh
from ..training.optim import encoder_optimizer, giraffe_optimizers
from ..utils.checkpoints import CheckpointIO, GiraffeRunConfigs
from ..utils.images import save_image_grid
from ..utils.logging import MetricsLogger
from .bbox import fixed_transformations
from .config import dc_disc_config_from_yaml, giraffe_config_from_yaml
from .discriminator import DCDiscriminator
from .generator import (
    GiraffeConfig,
    GiraffeGenerator,
    fixed_camera,
    giraffe_forward,
    sample_latent_codes,
)
from .trainer import (
    GiraffeTrainHParams,
    encoder_config,
    giraffe_d_step,
    giraffe_e_step,
    giraffe_g_step,
    sample_encoder_draws,
    sample_scene_draws,
)

VIS_SEED, VIS_TMP, VIS_N = 42, 0.65, 16


def evaluate_fid(g_ema: GiraffeGenerator, cfg: GiraffeConfig, n_images: int, batch_size: int,
                 fid_file: Optional[str], generator: torch.Generator) -> Optional[float]:
    """FID of ``n_images`` eval-mode images against ``fid_file``'s statistics,
    through the port's FID Inception (the seed ``calc_fid_stats`` uses);
    None without a ``fid_file``."""
    if not fid_file or not os.path.exists(fid_file):
        return None
    from ..evaluation import (
        calculate_activation_statistics,
        calculate_frechet_distance,
        compute_activations,
        load_inception,
        load_stats_npz,
    )

    device = next(g_ema.parameters()).device
    inc = load_inception(device=device)

    def batches():
        for _ in range(0, n_images, batch_size):
            with torch.no_grad():
                imgs = giraffe_forward(g_ema, cfg, generator, batch_size=batch_size, mode="eval")
            yield imgs * 2.0 - 1.0

    acts = compute_activations(inc, batches(), batch_size=batch_size)[:n_images]
    mu, sigma = calculate_activation_statistics(acts)
    return calculate_frechet_distance(mu, sigma, *load_stats_npz(fid_file))


def visualize(g_ema: GiraffeGenerator, cfg: GiraffeConfig, path: str, n: int = VIS_N) -> None:
    """A 4-wide grid of ``n`` eval-mode images: codes at 0.65 from seed 42,
    the fixed camera and boxes."""
    device = next(g_ema.parameters()).device
    codes = sample_latent_codes(torch.Generator().manual_seed(VIS_SEED), cfg, n, tmp=VIS_TMP,
                                device=device)
    with torch.no_grad():
        imgs = giraffe_forward(g_ema, cfg, latent_codes=codes,
                               camera_matrices=fixed_camera(cfg, n, device=device),
                               transformations=fixed_transformations(cfg.bbox, n, device=device),
                               mode="eval")
    save_image_grid(imgs.cpu().numpy() * 2.0 - 1.0, path, nrow=4)


def images_loader(cfg: Any, batch_size: int, seed: int) -> ImagesLoader:
    """The yaml's image glob as the GIRAFFE and gan2d trainers read it."""
    data = cfg["data"]
    dataset = ImagesDataset(data["path"], size=data.get("img_size", 64),
                            celebA_center_crop=data.get("celebA_center_crop", False),
                            random_crop=data.get("random_crop", False),
                            use_tanh_range=data.get("use_tanh_range", False))
    return ImagesLoader(dataset, batch_size, seed=seed)


def giraffe_run_configs(cfg: Any, args: Any) -> GiraffeRunConfigs:
    """The generator, discriminator, trainer and VAE configs of a loaded
    yaml and the model flags."""
    gcfg = giraffe_config_from_yaml(cfg, args)
    dcfg = dc_disc_config_from_yaml(cfg)
    tr = cfg["training"]
    hp = GiraffeTrainHParams(batch_size=tr.get("batch_size", 32),
                             lr_g=tr.get("learning_rate", 0.0005),
                             lr_d=tr.get("learning_rate_d", 0.0001),
                             optimizer=tr.get("optimizer", "RMSprop"))
    return GiraffeRunConfigs(gcfg, dcfg, hp, encoder_config(gcfg, dcfg.img_size))


def giraffe_models(configs: GiraffeRunConfigs, generator: torch.Generator, device,
                   vae: bool) -> tuple:
    """(G, D, G's EMA, their optimizers, the VAE and its optimizer) of
    ``configs`` on ``device``, the weights drawn from ``generator`` in the
    order G, D, VAE; the last two are None without ``vae``."""
    g = GiraffeGenerator(configs.generator, generator).to(device)
    d = DCDiscriminator(configs.discriminator, generator).to(device)
    g_opt, d_opt = giraffe_optimizers(configs.hp, g, d)
    e = e_opt = None
    if vae:
        e = VAEEncoder(configs.encoder, generator).to(device)
        e_opt = encoder_optimizer(e.parameters(), vae=True)
    return g, d, copy.deepcopy(g), g_opt, d_opt, e, e_opt


def train_giraffe(args: Any, cfg: Any, device: torch.device,
                  mesh: Optional[Mesh] = None) -> None:
    """Train GIRAFFE from a loaded yaml and the train entry's flags
    (``--seed``, ``--exit-after``, ``--vae`` and the model flags) on
    ``device``, over ``mesh`` (default: the launcher's world)."""
    configs = giraffe_run_configs(cfg, args)
    gcfg, hp = configs.generator, configs.hp
    mesh = training_mesh(hp.batch_size, mesh, device)
    tr = cfg["training"]
    out_dir = tr.get("out_dir", "out/giraffe")
    print_every = tr.get("print_every", 10)
    loader = iter(images_loader(cfg, hp.batch_size, args.seed))  # no image: nothing written
    logger = MetricsLogger(out_dir, "giraffe", print_every=print_every) if mesh.is_main else None

    gen = torch.Generator().manual_seed(args.seed)
    g, d, g_ema, g_opt, d_opt, e, e_opt = giraffe_models(configs, gen, device,
                                                         bool(getattr(args, "vae", 0)))

    ckpt = CheckpointIO(out_dir)
    it, fid_best = 0, float("inf")
    if ckpt.exists("model"):
        state = ckpt.load("model", map_location=device)
        for module, key in ((g, "g"), (d, "d"), (g_ema, "g_ema"), (g_opt, "g_opt"),
                            (d_opt, "d_opt")):
            module.load_state_dict(state[key])
        it, fid_best = int(state["it"]), float(state["fid_best"])
        print(f"resumed GIRAFFE from iteration {it}", flush=True)

    if e is not None and ckpt.exists("encoder"):
        est = ckpt.load("encoder", map_location=device)
        e.load_state_dict(est["e"])
        e_opt.load_state_dict(est["e_opt"])
        print("resumed VAE encoder", flush=True)
    replicate([g, d, g_ema, g_opt, d_opt, e, e_opt], mesh)

    def save_model():
        if mesh.is_main:
            ckpt.save("model", g=g.state_dict(), d=d.state_dict(), g_ema=g_ema.state_dict(),
                      g_opt=g_opt.state_dict(), d_opt=d_opt.state_dict(), it=it,
                      fid_best=fid_best)
            if e is not None:
                ckpt.save("encoder", e=e.state_dict(), e_opt=e_opt.state_dict())
        barrier(mesh)

    max_it = tr.get("max_it", 1000000)
    exit_after = getattr(args, "exit_after", -1)
    t0 = time.time()
    while it < max_it:
        it += 1
        x_real = shard_batch(torch.from_numpy(next(loader)).to(device), mesh)
        dm = giraffe_d_step(g, d, d_opt, gcfg, hp, x_real, shard_batch(
            sample_scene_draws(gen, gcfg, hp.batch_size, device), mesh), mesh)
        gm = giraffe_g_step(g, d, g_opt, g_ema, gcfg, hp, shard_batch(
            sample_scene_draws(gen, gcfg, hp.batch_size, device), mesh), mesh)
        if e is not None:
            gm.update(giraffe_e_step(e, g, d, e_opt, gcfg, x_real, shard_batch(
                sample_encoder_draws(gen, gcfg, hp.batch_size, device), mesh), mesh))

        if it % print_every == 0:
            log_metrics(logger, it, {**dm, **gm}, mesh)
        if it % tr.get("visualize_every", 1000) == 0 and mesh.is_main:
            visualize(g_ema, gcfg, os.path.join(out_dir, f"vis_{it:07d}.png"))
        if it % tr.get("checkpoint_every", 500) == 0:
            save_model()
        if it % tr.get("backup_every", 1000000) == 0:
            if mesh.is_main:
                ckpt.save(f"model_{it:07d}", g=g.state_dict(), d=d.state_dict(),
                          g_ema=g_ema.state_dict(), it=it)
            barrier(mesh)
        if it % tr.get("validate_every", 10000) == 0:
            # rank 0 alone scores (under the group's timeout), then every rank
            # takes its generator, which the FID draws advanced
            fid = (evaluate_fid(g_ema, gcfg, tr.get("n_eval_images", 10000), hp.batch_size,
                                cfg["data"].get("fid_file"), gen) if mesh.is_main else None)
            if fid is not None:
                logger.log(it, {"fid_score": fid})
                if fid < fid_best:
                    fid_best = fid
                    ckpt.save("model_best", g=g.state_dict(), d=d.state_dict(),
                              g_ema=g_ema.state_dict(), it=it, fid_best=fid_best)
            broadcast_generator(gen, mesh)
        if exit_after and exit_after > 0 and decide(time.time() - t0 > exit_after, mesh):
            save_model()
            print("time budget reached; checkpoint saved", flush=True)
            raise SystemExit(3)
    if logger is not None:
        logger.close()
