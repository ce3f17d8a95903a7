"""Stage C: inversion-encoder training, port of
``sdface_gan_tpu/training/encoder_loop.py:64-375``.

* ``--vae``: the VAE encoder -> z space; loss = 0.5 L(thumb) + 0.5 L(full)
  + 0.005 KL (the reference's operative path, ``training_utils.py:1016-1017``);
* ``--psp``: the GradualStyleEncoder -> a W+ stack driving the decoder
  (``input_is_latent``) plus the learned renderer-style projection, as
  offsets from the generator's mean styles (``PSPConfig.start_from_avg``),
  optionally warm-started from ``model_ir_se50``;
* the ``LossUtils`` ID / L2 / LPIPS bundle on full-res images with the
  perceptual weights of ``--irse_weights`` / ``--lpips_weights``; thumbs
  score L2 only;
* resume at step + 1 from ``models_{it:07d}`` (``e``, ``e_opt`` with
  Ranger's slow weights and step, ``step``), ``exit_after`` -> checkpoint +
  ``SystemExit(3)``, the ``eval.png`` target strip, 8-view sweep
  reconstruction grids, and the final ``encoder`` artifact ``{e, g_ema}``.

The generator is frozen: its parameters take no gradient, so backprop
reaches only the encoder (JAX differentiates the encoder parameters
alone).  Stage C's generator freezes its renderer too, which then runs
without autograd (on an NGP generator: the ``hash_encode`` kernel and
neither of its gradient kernels).  :func:`encoder_loss` takes its inputs
(images, thumbs, cameras, the reparameterisation noise) from
:class:`EncoderInputs`, so tests can pass the JAX package's draws;
``generator=None`` there is the deterministic forward (fixed depths,
stored decoder noise).

Over a data-parallel ``mesh`` (JAX ``encoder_loop.py:170-227``), as stages A
and B run (``training/loop.py``): each rank takes its rows of the loader's
global batch and of the cameras drawn at the global batch, the VAE's batch
statistics and its reparameterisation noise take the global batch inside the
step, and the gradients are averaged over the ranks; rank 0 writes.

The renderer type comes from ``resolve_renderer_type`` (the yaml's
``rendering: type`` or ``--ngp``), as in the port's other entries; the JAX
``train_encoder_stage`` reads the bare ``--ngp`` flag (ROADMAP queue 3).
"""

from __future__ import annotations

import os
import time
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from ..encoder import (
    LPIPS,
    IRSEBackbone,
    LossUtils,
    PSPConfig,
    PSPEncoder,
    VAEEncoder,
    VAEEncoderConfig,
    kl_divergence,
    load_lpips_archive,
    reparameterize,
)
from ..geometry.cameras import CameraParams, generate_camera_params
from ..models.generator import GeneratorConfig, generator_forward, mean_latent
from ..parallel.mesh import Mesh, decide, make_mesh, over, replicate, shard_batch
from ..utils.checkpoints import latest_checkpoint_step, load_checkpoint
from ..utils.device import resolve_device
from ..utils.images import save_image_grid
from ..utils.logging import MetricsLogger
from .loop import _as_batch, _generator, _timed, derived_seed, log_metrics, save_on_main
from .optim import encoder_optimizer
from .steps import Metrics, _step

EncoderConfig = Union[VAEEncoderConfig, PSPConfig]

THUMB_LOSS = LossUtils()  # L2 only: the perceptual nets assume full-res crops
KL_WEIGHT = 0.005


class EncoderInputs(NamedTuple):
    """One E step's inputs: real images [B, S, S, 3] and thumbs [B, r, r, 3]
    in [-1, 1], the cameras, the VAE's reparameterisation noise [B, z]
    (None: drawn from ``generator``), and the generator the forward draws
    from (None: deterministic)."""

    imgs: torch.Tensor
    thumbs: torch.Tensor
    cams: CameraParams
    eps: Optional[torch.Tensor] = None
    generator: Optional[torch.Generator] = None


def sample_encoder_inputs(imgs: torch.Tensor, thumbs: torch.Tensor, res: int,
                          generator: torch.Generator,
                          mesh: Optional[Mesh] = None) -> EncoderInputs:
    """The step's cameras (the default rig, as the JAX loop draws them) from
    ``generator``, which the forward then also draws from.  Over a ``mesh``
    the images are the rank's rows and the cameras are drawn at the global
    batch, the rank keeping its rows."""
    world = mesh.world if mesh is not None and mesh.distributed else 1
    cams = generate_camera_params(res, generator, batch=imgs.shape[0] * world,
                                  device=generator.device)
    return EncoderInputs(imgs, thumbs, shard_batch(cams, mesh), None, generator)


def encoder_loss(e: nn.Module, g_ema: nn.Module, gcfg: GeneratorConfig, ecfg: EncoderConfig,
                 loss_utils: LossUtils, inputs: EncoderInputs,
                 latent_avg: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 ) -> Tuple[torch.Tensor, Metrics]:
    """The E step's loss and metrics (JAX ``make_encoder_step``'s
    ``loss_fn``).  ``latent_avg``: ``(renderer_mean [1, style_dim],
    decoder_mean [1, 512])`` from ``mean_latent``; with it the pSp encoder's
    outputs are offsets from them."""
    cams = inputs.cams
    cam_args = (cams.extrinsics, cams.focal, cams.near, cams.far)
    if isinstance(ecfg, PSPConfig):
        rend_latent, wplus = e(inputs.imgs)
        if latent_avg is not None:
            rend_latent = rend_latent + latent_avg[0]
            wplus = wplus + latent_avg[1]
        out = generator_forward(g_ema, gcfg, [wplus], *cam_args, generator=inputs.generator,
                                input_is_latent=True, renderer_latent=rend_latent)
        kl = torch.zeros((), device=inputs.imgs.device)
    else:
        mu, logvar = e(inputs.imgs)
        z = reparameterize(mu, logvar, eps=inputs.eps, generator=inputs.generator)
        out = generator_forward(g_ema, gcfg, [z], *cam_args, generator=inputs.generator)
        kl = kl_divergence(mu, logvar)
    thumb_losses = THUMB_LOSS(out.thumb_rgb, inputs.thumbs)
    full_img = out.rgb if out.rgb is not None else out.thumb_rgb
    full_losses = loss_utils(full_img, inputs.imgs)
    loss = 0.5 * thumb_losses["loss"] + 0.5 * full_losses["loss"] + KL_WEIGHT * kl
    metrics = {"e_loss": loss, "e_kl": kl, "e_l2_thumb": thumb_losses["l2"],
               "e_l2_full": full_losses["l2"]}
    for name in ("id", "lpips"):
        if name in full_losses:
            metrics[f"e_{name}"] = full_losses[name]
    return loss, metrics


def encoder_step(e: nn.Module, g_ema: nn.Module, opt: torch.optim.Optimizer,
                 gcfg: GeneratorConfig, ecfg: EncoderConfig, loss_utils: LossUtils,
                 inputs: EncoderInputs,
                 latent_avg: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 mesh: Optional[Mesh] = None) -> Metrics:
    """One optimizer step of the encoder on :func:`encoder_loss`, over the
    ranks of ``mesh``."""
    with over(mesh):
        loss, metrics = encoder_loss(e, g_ema, gcfg, ecfg, loss_utils, inputs,
                                     latent_avg=latent_avg)
        _step(opt, loss, mesh)
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def reconstruct(e: nn.Module, g_ema: nn.Module, gcfg: GeneratorConfig, ecfg: EncoderConfig,
                img1: torch.Tensor, cams: CameraParams,
                trunc: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """One identity [1, S, S, 3] -> its reconstruction from the cameras'
    views (deterministic forward): the VAE's mu at truncation 0.5 about the
    mean styles, pSp's W+ (offsets from the mean under ``start_from_avg``)."""
    n = cams.extrinsics.shape[0]
    cam_args = (cams.extrinsics, cams.focal, cams.near, cams.far)
    if isinstance(ecfg, PSPConfig):
        rend, wplus = e(img1)
        if ecfg.start_from_avg:
            rend, wplus = rend + trunc[0], wplus + trunc[1]
        out = generator_forward(g_ema, gcfg, [wplus.expand(n, -1, -1)], *cam_args,
                                input_is_latent=True, renderer_latent=rend.expand(n, -1))
    else:
        mu, _ = e(img1)
        out = generator_forward(g_ema, gcfg, [mu.expand(n, -1)], *cam_args, truncation=0.5,
                                truncation_latent=trunc)
    return out.rgb if out.rgb is not None else out.thumb_rgb


def _encoder(ecfg: EncoderConfig, seed: int) -> nn.Module:
    generator = torch.Generator().manual_seed(derived_seed(seed, "e"))
    if isinstance(ecfg, PSPConfig):
        return PSPEncoder(ecfg, generator)
    return VAEEncoder(ecfg, generator)


def train_encoder(
    loader,
    gcfg: GeneratorConfig,
    g_ema: nn.Module,
    ecfg: EncoderConfig,
    out_dir: str,
    loss_utils: Optional[LossUtils] = None,
    e_init: Optional[nn.Module] = None,
    iters: int = 100000,
    log_every: int = 100,
    save_every: int = 10000,
    sample_every: int = 1000,
    exit_after: Optional[float] = None,
    val_n_sample: int = 4,
    seed: int = 0,
    device: Union[str, torch.device] = "cuda",
    mesh: Optional[Mesh] = None,
) -> nn.Module:
    """Train an inversion encoder against the frozen ``g_ema`` (a
    ``full_pipeline`` generator, frozen here in place).  ``loader`` yields
    (imgs [B, S, S, 3], thumbs [B, r, r, 3]) in [-1, 1]: this rank's rows
    of the global batch over ``mesh`` (default: the launcher's world).  Each
    logged iteration carries its E step's ``e_ms``.  Returns the encoder;
    writes the final ``encoder`` artifact ``{e, g_ema}``."""
    device = resolve_device(device)
    mesh = mesh if mesh is not None else make_mesh(device)
    psp = isinstance(ecfg, PSPConfig)
    if psp and gcfg.full_pipeline and gcfg.decoder.style_dim != 512:
        raise ValueError(
            "pSp W+ styles are 512-d (GradualStyleEncoder output); the decoder "
            f"style_dim is {gcfg.decoder.style_dim}: pSp requires style_dim=256 "
            "generators (decoder style 512)")
    os.makedirs(out_dir, exist_ok=True)
    logger = MetricsLogger(out_dir, "encoder", print_every=log_every) if mesh.is_main else None
    g_ema.requires_grad_(False)
    e = (e_init if e_init is not None else _encoder(ecfg, seed)).to(device)
    opt = encoder_optimizer(e.parameters(), vae=not psp)

    start_iter = 0
    latest = latest_checkpoint_step(out_dir)
    if latest is not None:
        ck = load_checkpoint(out_dir, f"models_{latest:07d}", map_location=device)
        e.load_state_dict(ck["e"])
        opt.load_state_dict(ck["e_opt"])
        start_iter = int(ck["step"]) + 1  # saved after step i: resume at i + 1
        print(f"resumed encoder at step {start_iter}")
    replicate([e, opt, g_ema], mesh)

    loss_utils = loss_utils or LossUtils()
    data = iter(loader)
    # fixed eval identities: the first loader batch, saved once as the target strip
    first_imgs, _ = next(data)
    eval_imgs = _as_batch(first_imgs, device)[:val_n_sample]
    if start_iter == 0 and sample_every and mesh.is_main:
        save_image_grid(eval_imgs.cpu().numpy(), os.path.join(out_dir, "eval.png"), nrow=1)

    res = gcfg.renderer.out_im_res
    with torch.no_grad():
        trunc = mean_latent(g_ema, torch.Generator(device=device).manual_seed(2))
    latent_avg = trunc if (psp and ecfg.start_from_avg) else None

    def viz(i):
        n = eval_imgs.shape[0]
        cams = generate_camera_params(res, torch.Generator(device=device).manual_seed(1),
                                      batch=n, sweep=True, device=device)
        rows = [reconstruct(e, g_ema, gcfg, ecfg, eval_imgs[k:k + 1],
                            CameraParams(*(c[8 * k:8 * (k + 1)] for c in cams)), trunc)
                for k in range(n)]
        save_image_grid(torch.cat(rows).float().cpu().numpy(),
                        os.path.join(out_dir, f"samples_{i:07d}.png"), nrow=8)

    t_start = time.time()
    for i in range(start_iter, iters):
        imgs, thumbs = next(data)
        inputs = sample_encoder_inputs(_as_batch(imgs, device), _as_batch(thumbs, device), res,
                                       _generator(device, seed, "C", i), mesh)
        m, e_ms = _timed(device, lambda: encoder_step(e, g_ema, opt, gcfg, ecfg, loss_utils,
                                                      inputs, latent_avg=latent_avg, mesh=mesh))
        if i % log_every == 0:
            log_metrics(logger, i, {**m, "e_ms": e_ms()}, mesh)
        if sample_every and i % sample_every == 0 and mesh.is_main:
            viz(i)
        cut = exit_after is not None and decide(time.time() - t_start > exit_after, mesh)
        if (save_every and i and i % save_every == 0) or cut:
            save_on_main(mesh, out_dir, f"models_{i:07d}", lambda: {
                "e": e.state_dict(), "e_opt": opt.state_dict(), "step": i})
        if cut:
            if logger is not None:
                logger.close()
            print("time budget reached; checkpoint saved (exit code 3 contract)")
            raise SystemExit(3)
    # the matched pair: the encoder with its frozen generator
    save_on_main(mesh, out_dir, "encoder", lambda: {"e": e.state_dict(),
                                                    "g_ema": g_ema.state_dict()})
    if logger is not None:
        logger.close()
    return e


def load_irse_archive(model: nn.Module, path: str, head: bool = True) -> nn.Module:
    """Load a ``model_ir_se50.pth`` state dict into an ``IRSEBackbone`` (or a
    pSp encoder's ``gse.backbone``), in place.  Every tensor but BatchNorm's
    ``num_batches_tracked`` must be in the archive; with ``head=False`` the
    embedding head (``output_layer.*``, which the pSp encoder does not run)
    may be missing and then keeps its values, as the JAX
    ``import_irse_state`` allows.  (JAX allows that for the ID loss too,
    which then embeds through a random head; the port refuses it there.)"""
    state = torch.load(path, map_location="cpu", weights_only=True)
    missing = [k for k in model.state_dict()
               if k not in state and not k.endswith("num_batches_tracked")
               and (head or not k.startswith("output_layer."))]
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} ir_se-50 tensors, e.g. {missing[:3]}")
    model.load_state_dict({k: v for k, v in state.items() if k in model.state_dict()},
                          strict=False)
    return model


def load_perceptual_params(args: Any, device: Union[str, torch.device] = "cuda") -> LossUtils:
    """The stage-C loss bundle, with the ArcFace / LPIPS weights of
    ``args.irse_weights`` / ``args.lpips_weights`` when given (an LPIPS
    archive holds both state dicts: ``{"alex": ..., "lin": ...}``)."""
    device = resolve_device(device)
    irse = lpips = None
    if getattr(args, "irse_weights", None):
        irse = load_irse_archive(IRSEBackbone(), args.irse_weights).to(device)
        print(f"loaded ArcFace ID-loss weights from {args.irse_weights}")
    if getattr(args, "lpips_weights", None):
        bundle = torch.load(args.lpips_weights, map_location="cpu", weights_only=True)
        lpips = load_lpips_archive(LPIPS(), bundle).to(device)
        print(f"loaded LPIPS weights from {args.lpips_weights}")
    return LossUtils(irse=irse, lpips=lpips)


def encoder_config(gcfg: GeneratorConfig, img_size: int, psp: bool) -> EncoderConfig:
    """The encoder that stage C trains against the generator ``gcfg`` at
    ``img_size``: pSp (``psp``) or the VAE."""
    if psp:
        return PSPConfig(img_size=img_size, style_count=gcfg.decoder.n_latent,
                         renderer_style_dim=gcfg.style_dim)
    return VAEEncoderConfig(img_size=img_size, z_size=gcfg.style_dim)


def train_encoder_stage(args: Any, cfg: Any, out_base: str, iters: int = 100000,
                        device: Union[str, torch.device] = "cuda",
                        mesh: Optional[Mesh] = None, **kwargs) -> nn.Module:
    """Stage C as the train entry runs it: the generator config resolved as
    stage B's (the renderer type by ``resolve_renderer_type``), the frozen
    ``full_pipeline`` generator, the record-store loader, and
    :func:`train_encoder` into ``encoder`` or ``encoder_psp``."""
    from ..config.build import generator_config, stage_options
    from ..data import DataLoader, MultiResolutionDataset, resolve_record_dir
    from ..utils.checkpoints import load_generator

    device = resolve_device(device)
    mesh = mesh if mesh is not None else make_mesh(device)
    img_size = cfg["data"].get("img_size", 256)
    psp = bool(getattr(args, "psp", 0))
    opt = stage_options(cfg, False, ngp=bool(getattr(args, "ngp", 0)),
                        fc=bool(getattr(args, "fc", 0)), batch=args.batch)
    gcfg = generator_config(opt, stage_a=False)
    g_ema = load_generator(out_base, "full_pipeline", gcfg, device=device)

    ecfg = encoder_config(gcfg, img_size, psp)
    e_init = None
    if psp and getattr(args, "irse_weights", None):
        # warm-start the FPN backbone from ArcFace (reference strict=False
        # load, training_utils.py:938-940)
        e_init = _encoder(ecfg, getattr(args, "seed", 0))
        load_irse_archive(e_init.gse.backbone, args.irse_weights, head=False)
        print("pSp backbone warm-started from ir_se50 weights")

    data_path = args.dataset_path or resolve_record_dir(cfg["data"]["path"])
    ds = MultiResolutionDataset(data_path, resolution=img_size,
                                nerf_resolution=gcfg.renderer.out_im_res)
    try:
        with DataLoader(ds, batch_size=args.batch, seed=getattr(args, "seed", 0),
                        host_id=mesh.rank, num_hosts=mesh.world) as loader:
            # one directory per encoder type: a resume never loads a VAE into pSp
            return train_encoder(
                loader, gcfg, g_ema, ecfg,
                os.path.join(out_base, "encoder_psp" if psp else "encoder"),
                loss_utils=load_perceptual_params(args, device), e_init=e_init, iters=iters,
                seed=getattr(args, "seed", 0), device=device, mesh=mesh, **kwargs)
    finally:
        ds.close()
