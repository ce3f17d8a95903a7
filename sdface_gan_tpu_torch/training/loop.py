"""Staged training loops, port of ``sdface_gan_tpu/training/loop.py``:
sphere init -> volume renderer (stage A) -> full pipeline (stage B).

* auto-resume from the newest ``models_{it:07d}`` checkpoint, at step + 1
  (checkpoints are written after step i completes);
* the sphere-init warm-up (batch 3, the G optimizer, then a fresh G
  optimizer) saved as ``sdf_init_models``, skipped on resume;
* periodic ``models_*`` saves and the stage artifacts ``vol_renderer`` and
  ``full_pipeline``;
* stage B starts from the stage-A EMA weights by a shape-matched copy and
  alternates the lazy-R1 D and the path-length step on the reference
  cadences, folding the EMA after the path step;
* randomness of iteration i comes from generators seeded by (seed, stage,
  i), not from one sequential stream, so a resumed run draws fresh inputs;
* ``exit_after`` seconds: save and exit with code 3;
* sample grids on a sweep-camera rig every ``sample_every`` iterations.

The loader is any iterable of ``(img, thumb)`` channel-last arrays or
tensors in [-1, 1].  Both loops run on ``device="cuda"`` unless the
caller passes ``device="cpu"``, and raise without a card.  Each logged
iteration carries the time of its D, G (and path) step, ``d_ms``,
``g_ms``, ``path_ms``: CUDA events on the card, the host clock on the CPU.

Both loops run data-parallel over ``mesh`` (default: the launcher's world,
:func:`..parallel.make_mesh`; the world of one without it), as JAX's run over
its device mesh: every rank builds the same modules, which are then
replicated from rank 0 (after construction, resume and sphere init); the
loader yields the rank's rows (``DataLoader(host_id=rank, num_hosts=world)``);
each step draws at the global batch and averages its gradients over the ranks
(``training/steps.py``).  Rank 0 alone writes checkpoints, grids and
metrics (averaged over the ranks), each write followed by a barrier; every
rank loads on resume.  The ``exit_after`` cut is decided on rank 0's clock
and broadcast, so that every rank saves the same step and exits 3.  The
world must divide the global batch: the ranks are processes the launcher
started, so JAX's single-process trim to a prefix of devices has no
counterpart.
"""

from __future__ import annotations

import copy
import hashlib
import os
import time
from typing import Callable, Optional, Union

import numpy as np
import torch
from torch import nn

from ..geometry.cameras import generate_camera_params
from ..models.discriminator import (
    StyleDiscConfig,
    StyleDiscriminator,
    VolumeRenderDiscConfig,
    VolumeRenderDiscriminator,
)
from ..models.generator import Generator, GeneratorConfig, generator_forward, mean_latent
from ..parallel.mesh import Mesh, barrier, decide, make_mesh, mean_metrics, replicate
from ..utils.checkpoints import (
    checkpoint_exists,
    latest_checkpoint_step,
    load_checkpoint,
    save_checkpoint,
)
from ..utils.device import resolve_device
from ..utils.images import save_image_grid
from ..utils.logging import MetricsLogger
from .ema import accumulate
from .optim import stage_a_optimizers, stage_b_optimizers
from .steps import (
    TrainHParams,
    sample_inputs,
    sphere_init_step,
    stage_a_d_step,
    stage_a_g_step,
    stage_b_d_step,
    stage_b_g_step,
    stage_b_path_step,
)


def derived_seed(*parts) -> int:
    """A 63-bit seed from ``parts`` (e.g. seed, stage, iteration, role)."""
    digest = hashlib.sha256("/".join(map(str, parts)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def _generator(device: torch.device, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derived_seed(*parts))


def _timed(device: torch.device, fn: Callable):
    """``fn()`` and a callable giving its milliseconds: CUDA events on the
    card (read, with a wait, only when asked for), the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        ms = (time.perf_counter() - t0) * 1e3
        return out, lambda: ms
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()

    def elapsed():
        end.synchronize()
        return start.elapsed_time(end)

    return out, elapsed


def training_mesh(batch: int, mesh: Optional[Mesh], device: torch.device) -> Mesh:
    """The data-parallel world of a stage: ``mesh``, or the launcher's
    (JAX's ``_training_mesh``); the world must divide the global ``batch``."""
    mesh = mesh if mesh is not None else make_mesh(device)
    if batch % mesh.world:
        raise ValueError(f"global batch {batch} must divide across the "
                         f"{mesh.world}-rank world")
    return mesh


def rank_batch(x, device: torch.device, mesh: Mesh, batch: int) -> torch.Tensor:
    """A loader batch as a tensor: this rank's ``batch // world`` rows."""
    x = _as_batch(x, device)
    if mesh.distributed and x.shape[0] != batch // mesh.world:
        raise ValueError(f"the loader yielded {x.shape[0]} rows; rank {mesh.rank} takes "
                         f"{batch // mesh.world} of the global batch {batch} "
                         "(DataLoader(host_id=rank, num_hosts=world))")
    return x


def log_metrics(logger: Optional[MetricsLogger], step: int, metrics: dict,
                mesh: Mesh) -> None:
    """Every rank's metrics averaged; rank 0 (the one with a logger) writes."""
    metrics = mean_metrics(metrics, mesh)
    if logger is not None:
        logger.log(step, metrics)


def save_on_main(mesh: Mesh, out_dir: str, name: str, state_fn: Callable[[], dict]) -> None:
    """Rank 0 writes ``state_fn()``; every rank waits until it is on disk."""
    if mesh.is_main:
        save_checkpoint(out_dir, name, state_fn())
    barrier(mesh)


def _frozen_copy(model: nn.Module) -> nn.Module:
    ema = copy.deepcopy(model)
    ema.requires_grad_(False)
    return ema


def copy_matching(dst: nn.Module, src_state: dict) -> None:
    """Shape-matched partial copy (reference cross-stage transfer,
    ``training_utils.py:604-610``): every entry of ``dst``'s state dict
    whose name and shape ``src_state`` has takes its value, in place."""
    state = dst.state_dict()
    for name, value in state.items():
        other = src_state.get(name)
        if other is not None and tuple(other.shape) == tuple(value.shape):
            state[name] = other
    dst.load_state_dict(state)


def _as_batch(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=device)


@torch.no_grad()
def _sample_grid(g_ema: Generator, gcfg: GeneratorConfig, hp: TrainHParams, path: str,
                 n_identities: int = 4, truncation: float = 0.7) -> None:
    """An (identities x 8 sweep views) grid from the EMA generator, in eval
    mode (fixed depths, stored decoder noise), truncated toward the mean."""
    device = next(g_ema.parameters()).device
    z = torch.randn((n_identities, hp.style_dim), device=device,
                    generator=torch.Generator(device=device).manual_seed(0))
    cam = hp.camera
    cams = generate_camera_params(gcfg.renderer.out_im_res,
                                  torch.Generator(device=device).manual_seed(1),
                                  batch=n_identities, sweep=True, uniform=cam.uniform,
                                  azim_range=cam.azim, elev_range=cam.elev, fov_ang=cam.fov,
                                  dist_radius=cam.dist_radius, device=device)
    trunc = mean_latent(g_ema, torch.Generator(device=device).manual_seed(2))
    rows = []
    for i in range(n_identities):  # one identity (8 sweep views) at a time
        sl = slice(8 * i, 8 * (i + 1))
        out = generator_forward(g_ema, gcfg, [z[i:i + 1].expand(8, -1)],
                                cams.extrinsics[sl], cams.focal[sl], cams.near[sl],
                                cams.far[sl], truncation=truncation, truncation_latent=trunc)
        rows.append((out.rgb if out.rgb is not None else out.thumb_rgb).float().cpu().numpy())
    save_image_grid(np.concatenate(rows), path, nrow=8)


def _stage_state(g, d, g_ema, g_opt, d_opt, step, **extra) -> dict:
    return {"g": g.state_dict(), "d": d.state_dict(), "g_ema": g_ema.state_dict(),
            "g_opt": g_opt.state_dict(), "d_opt": d_opt.state_dict(), "step": step, **extra}


def train_volume_renderer(
    loader,
    gcfg: GeneratorConfig,
    dcfg: VolumeRenderDiscConfig,
    hp: TrainHParams,
    out_dir: str,
    iters: int = 200000,
    sphere_init_iters: int = 10000,
    no_sphere_init: bool = False,
    save_every: int = 10000,
    sample_every: int = 1000,
    log_every: int = 100,
    seed: int = 0,
    exit_after: Optional[float] = None,
    device: Union[str, torch.device] = "cuda",
    mesh: Optional[Mesh] = None,
) -> Generator:
    """Stage A (reference ``train_vol_render``, ``training_utils.py:197-549``).
    Returns the EMA generator; writes ``vol_renderer`` on completion."""
    device = resolve_device(device)
    mesh = training_mesh(hp.batch, mesh, device)
    os.makedirs(out_dir, exist_ok=True)
    logger = MetricsLogger(out_dir, "vol_render", print_every=log_every) if mesh.is_main else None
    g = Generator(gcfg, device=device, generator=torch.Generator().manual_seed(
        derived_seed(seed, "g")))
    d = VolumeRenderDiscriminator(dcfg, generator=torch.Generator().manual_seed(
        derived_seed(seed, "d"))).to(device)
    g_opt, d_opt = stage_a_optimizers(g, d, hp.a_d_reg_every)

    start_iter, resumed = 0, False
    latest = latest_checkpoint_step(out_dir)
    if latest is not None:
        ck = load_checkpoint(out_dir, f"models_{latest:07d}", map_location=device)
        g.load_state_dict(ck["g"])
        d.load_state_dict(ck["d"])
        g_ema = _frozen_copy(g)
        g_ema.load_state_dict(ck["g_ema"])
        g_opt.load_state_dict(ck["g_opt"])
        d_opt.load_state_dict(ck["d_opt"])
        start_iter, resumed = int(ck["step"]) + 1, True
        print(f"resumed volume renderer at step {start_iter}")
    elif checkpoint_exists(out_dir, "sdf_init_models"):
        ck = load_checkpoint(out_dir, "sdf_init_models", map_location=device)
        g.load_state_dict(ck["g"])
        g_ema = _frozen_copy(g)
        g_ema.load_state_dict(ck["g_ema"])
        resumed = True
        print("loaded sphere-initialized model")
    else:
        g_ema = _frozen_copy(g)
    replicate([g, d, g_ema, g_opt, d_opt], mesh)

    res = gcfg.renderer.out_im_res
    if gcfg.renderer.with_sdf and not no_sphere_init and not resumed:
        # every rank runs the (replicated) warm-up; rank 0's result is kept
        # batch 3 and the main G optimizer (training_utils.py:287-327)
        init_hp = TrainHParams(batch=3, style_dim=hp.style_dim, camera=hp.camera)
        t0 = time.time()
        for i in range(sphere_init_iters):
            inputs = sample_inputs(init_hp, res, init_hp.batch,
                                   _generator(device, seed, "sphere", i))
            m = sphere_init_step(g, g_opt, gcfg, init_hp, inputs)
            if i % max(log_every, 100) == 0 and logger is not None:
                logger.log(i, m)
        replicate([g], mesh)
        g_ema = _frozen_copy(g)
        save_on_main(mesh, out_dir, "sdf_init_models",
                     lambda: {"g": g.state_dict(), "g_ema": g_ema.state_dict()})
        print(f"sphere init done in {time.time() - t0:.0f}s")
        g_opt, _ = stage_a_optimizers(g, d, hp.a_d_reg_every)  # fresh G state

    data = iter(loader)
    t_start = time.time()
    for i in range(start_iter, iters):
        _, thumbs = next(data)
        real = rank_batch(thumbs, device, mesh, hp.batch)
        d_in = sample_inputs(hp, res, hp.batch, _generator(device, seed, "A", i, "d"),
                             mesh=mesh)
        g_in = sample_inputs(hp, res, hp.batch, _generator(device, seed, "A", i, "g"),
                             mesh=mesh)
        dm, d_ms = _timed(device, lambda: stage_a_d_step(
            g, d, d_opt, gcfg, dcfg, hp, real, d_in, with_r1=i % hp.a_d_reg_every == 0,
            mesh=mesh))
        gm, g_ms = _timed(device, lambda: stage_a_g_step(
            g, d, g_opt, g_ema, gcfg, dcfg, hp, g_in, mesh=mesh))
        if i % log_every == 0:
            extra = {"d_ms": d_ms(), "g_ms": g_ms()}
            if gcfg.renderer.with_sdf:  # the learned sharpness; its anneal is a health signal
                extra["beta"] = g.renderer.sigmoid_beta.detach()[0]
            log_metrics(logger, i, {**dm, **gm, **extra}, mesh)
        if sample_every and i % sample_every == 0 and mesh.is_main:
            _sample_grid(g_ema, gcfg, hp, os.path.join(out_dir, f"samples_{i:07d}.png"))
        cut = exit_after is not None and decide(time.time() - t_start > exit_after, mesh)
        if (save_every and i and i % save_every == 0) or cut:
            save_on_main(mesh, out_dir, f"models_{i:07d}",
                         lambda: _stage_state(g, d, g_ema, g_opt, d_opt, i))
        if cut:
            if logger is not None:
                logger.close()
            print("time budget reached; checkpoint saved (exit code 3 contract)")
            raise SystemExit(3)

    save_on_main(mesh, out_dir, "vol_renderer", lambda: {
        "g": g.state_dict(), "d": d.state_dict(), "g_ema": g_ema.state_dict()})
    if logger is not None:
        logger.close()
    return g_ema


def train_full_pipeline(
    loader,
    gcfg: GeneratorConfig,
    dcfg: StyleDiscConfig,
    hp: TrainHParams,
    out_dir: str,
    vol_renderer_dir: Optional[str] = None,
    init_from: str = "vol_renderer",
    iters: int = 300000,
    save_every: int = 10000,
    sample_every: int = 1000,
    log_every: int = 100,
    seed: int = 0,
    exit_after: Optional[float] = None,
    device: Union[str, torch.device] = "cuda",
    mesh: Optional[Mesh] = None,
) -> Generator:
    """Stage B (reference ``train_full_pipeline``, ``training_utils.py:552-881``).
    ``gcfg`` should freeze the renderer, as the JAX resolution does.
    Returns the EMA generator; writes ``full_pipeline`` at the end."""
    device = resolve_device(device)
    mesh = training_mesh(hp.batch, mesh, device)
    os.makedirs(out_dir, exist_ok=True)
    logger = (MetricsLogger(out_dir, "full_pipeline", print_every=log_every)
              if mesh.is_main else None)
    g = Generator(gcfg, device=device, generator=torch.Generator().manual_seed(
        derived_seed(seed, "g")))
    d = StyleDiscriminator(dcfg, generator=torch.Generator().manual_seed(
        derived_seed(seed, "d"))).to(device)
    g_opt, d_opt = stage_b_optimizers(g, d, lr=2e-3, g_reg_every=hp.g_reg_every,
                                      d_reg_every=hp.d_reg_every)

    start_iter = 0
    latest = latest_checkpoint_step(out_dir)
    if latest is not None:
        ck = load_checkpoint(out_dir, f"models_{latest:07d}", map_location=device)
        g.load_state_dict(ck["g"])
        d.load_state_dict(ck["d"])
        g_ema = _frozen_copy(g)
        g_ema.load_state_dict(ck["g_ema"])
        g_opt.load_state_dict(ck["g_opt"])
        d_opt.load_state_dict(ck["d_opt"])
        mean_path_length = ck["mean_path_length"].to(device)
        start_iter = int(ck["step"]) + 1
        print(f"resumed full pipeline at step {start_iter}")
    else:
        src_dir = vol_renderer_dir or out_dir
        if not checkpoint_exists(src_dir, init_from):
            # a frozen random renderer would train for the whole stage
            raise FileNotFoundError(
                f"stage-B init checkpoint '{init_from}' not found under {src_dir}; "
                "run stage A first")
        copy_matching(g, load_checkpoint(src_dir, init_from, map_location=device)["g_ema"])
        print(f"initialized renderer from {init_from}")
        g_ema = _frozen_copy(g)
        mean_path_length = torch.zeros((), device=device)
    replicate([g, d, g_ema, g_opt, d_opt, mean_path_length], mesh)

    res = gcfg.renderer.out_im_res
    n_latent = gcfg.decoder.n_latent
    path_batch = max(1, hp.batch // hp.path_batch_shrink)
    data = iter(loader)
    t_start = time.time()
    for i in range(start_iter, iters):
        imgs, _ = next(data)
        real = rank_batch(imgs, device, mesh, hp.batch)
        d_in = sample_inputs(hp, res, hp.batch, _generator(device, seed, "B", i, "d"), n_latent,
                             mesh)
        g_in = sample_inputs(hp, res, hp.batch, _generator(device, seed, "B", i, "g"), n_latent,
                             mesh)
        dm, d_ms = _timed(device, lambda: stage_b_d_step(
            g, d, d_opt, gcfg, dcfg, hp, real, d_in, regularize=i % hp.d_reg_every == 0,
            mesh=mesh))
        gm, g_ms = _timed(device, lambda: stage_b_g_step(g, d, g_opt, gcfg, dcfg, hp, g_in,
                                                         mesh=mesh))
        times = {"d_ms": d_ms, "g_ms": g_ms}
        if hp.g_reg_every > 0 and i % hp.g_reg_every == 0:
            p_in = sample_inputs(hp, res, path_batch,
                                 _generator(device, seed, "B", i, "path"), n_latent, mesh)
            (mean_path_length, pm), times["path_ms"] = _timed(device, lambda: stage_b_path_step(
                g, g_opt, gcfg, hp, p_in, mean_path_length, mesh=mesh))
            gm = {**gm, **pm}
        accumulate(g_ema, g)
        if i % log_every == 0:
            log_metrics(logger, i, {**dm, **gm, **{k: ms() for k, ms in times.items()}}, mesh)
        if sample_every and i % sample_every == 0 and mesh.is_main:
            _sample_grid(g_ema, gcfg, hp, os.path.join(out_dir, f"samples_{i:07d}.png"))
        cut = exit_after is not None and decide(time.time() - t_start > exit_after, mesh)
        if (save_every and i and i % save_every == 0) or cut:
            save_on_main(mesh, out_dir, f"models_{i:07d}", lambda: _stage_state(
                g, d, g_ema, g_opt, d_opt, i, mean_path_length=mean_path_length))
        if cut:
            if logger is not None:
                logger.close()
            print("time budget reached; checkpoint saved (exit code 3 contract)")
            raise SystemExit(3)

    save_on_main(mesh, out_dir, "full_pipeline", lambda: {
        "g": g.state_dict(), "d": d.state_dict(), "g_ema": g_ema.state_dict()})
    if logger is not None:
        logger.close()
    return g_ema
