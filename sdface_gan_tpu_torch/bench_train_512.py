"""512^2 stage-B training steps of the port, port of ``scripts/bench_train_512.py``.

    python -m sdface_gan_tpu_torch.bench_train_512 [batches ...] [--iters N] [--device cuda]

The three stage-B steps of ``configs/512res/ffhq_512_sdf_tpu.yaml`` at its
widths, resolved from the yaml through the port's own loader as ``train
--sdf 1`` resolves it (the generator, the StyleGAN2 D at 512^2, the
hyperparameters with ``g_param_dtype: bfloat16``): the D step with R1
(double backward), the G step (nonsaturating + content) and the path-length
step on ``batch // path_batch_shrink``, with the decoder-only G optimizer
(``training.optim.stage_b_optimizers``), at batches 2, 4 and 8 by default.
Random weights from a seeded ``torch.Generator``; each step's inputs drawn
in the step from a seeded generator on the device; TF32 off.  Each step
kind runs once, then ``ITERS`` (``--iters``) times under the host clock after a
synchronise (each call also timed by CUDA events).

One JSON line per batch with the JAX script's keys (``d_r1_ms``, ``g_ms``,
``path_ms``, ``it_per_s_combined`` = 1000 / (D + G + path / ``g_reg_every``),
``fits_hbm``, ``peak_hbm_gb`` from ``torch.cuda.max_memory_allocated``),
plus each step kind's per-call ms median and max and the card.  Only
``torch.cuda.OutOfMemoryError`` is a miss (``fits_hbm: false``); any other
error raises.
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import replace

import torch

from . import bench
from .bench_serving_512 import CONFIG, peak_memory_gb, reset_peak
from .config import build, load_config
from .config.yaml_config import REPO_ROOT, default_config_path
from .models.discriminator import StyleDiscriminator
from .models.generator import Generator
from .training.optim import stage_b_optimizers
from .training.steps import (
    sample_inputs,
    stage_b_d_step,
    stage_b_g_step,
    stage_b_path_step,
)
from .utils.device import disable_tf32, resolve_device

BATCHES = (2, 4, 8)
ITERS = 10
BENCH = "512x512 stage-B steps"


def configs_512():
    """(generator, stage-B D, hyperparameters) of ``CONFIG``, stage B."""
    cfg = load_config(os.path.join(REPO_ROOT, CONFIG), default_config_path())
    opt = build.stage_options(cfg, False)
    gcfg = build.generator_config(opt, stage_a=False)
    _, dcfg = build.discriminator_configs(opt)
    hp = build.train_hparams(opt)
    assert gcfg.size == 512 and hp.g_param_dtype == "bfloat16", (gcfg.size, hp.g_param_dtype)
    return gcfg, dcfg, hp


def bench_batch(gcfg, dcfg, hp0, g, d, batch: int, device: torch.device,
                iters: int = ITERS, seed: int = 0) -> dict:
    """One batch's line: fresh optimizers, then each step kind once and
    ``iters`` times timed; ``fits_hbm`` false on ``torch.cuda.OutOfMemoryError``."""
    hp = replace(hp0, batch=batch)
    res, n_latent = gcfg.renderer.out_im_res, gcfg.decoder.n_latent
    path_batch = max(1, batch // hp.path_batch_shrink)
    row = {"bench": BENCH, "batch": batch, "g_param_dtype": hp.g_param_dtype}
    reset_peak(device)
    try:
        g_opt, d_opt = stage_b_optimizers(g, d, g_reg_every=hp.g_reg_every,
                                          d_reg_every=hp.d_reg_every)
        real = torch.rand((batch, gcfg.size, gcfg.size, 3), device=device,
                          generator=torch.Generator(device=device).manual_seed(seed)) * 2 - 1
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        mean_path_length = torch.zeros((), device=device)

        def path_step(_):
            nonlocal mean_path_length
            inputs = sample_inputs(hp, res, path_batch, gen, n_latent)
            mean_path_length, metrics = stage_b_path_step(g, g_opt, gcfg, hp, inputs,
                                                          mean_path_length)
            return metrics

        steps = {
            "d_r1": lambda _: stage_b_d_step(g, d, d_opt, gcfg, dcfg, hp, real,
                                             sample_inputs(hp, res, batch, gen, n_latent),
                                             regularize=True),
            "g": lambda _: stage_b_g_step(g, d, g_opt, gcfg, dcfg, hp,
                                          sample_inputs(hp, res, batch, gen, n_latent)),
            "path": path_step,
        }
        finite = True
        for name, step in steps.items():
            step(-1)  # warm-up
            t = bench.time_iterations(step, device, iters)
            row[f"{name}_ms"] = 1e3 * t["seconds"] / iters
            row[f"{name}_iter_ms_median"] = t["iter_ms_median"]
            row[f"{name}_iter_ms_max"] = t["iter_ms_max"]
            finite &= all(bool(torch.isfinite(v).all()) for v in t["out"].values())
        row["it_per_s_combined"] = 1e3 / (row["d_r1_ms"] + row["g_ms"]
                                          + row["path_ms"] / hp.g_reg_every)
        row.update(fits_hbm=True, peak_hbm_gb=peak_memory_gb(device), finite=finite)
        del g_opt, d_opt, real
    except torch.cuda.OutOfMemoryError as e:
        row.update(fits_hbm=False, error=str(e).splitlines()[0][:200])
    reset_peak(device)
    return row


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description="512^2 stage-B steps of the PyTorch port.")
    p.add_argument("batches", type=int, nargs="*", default=list(BATCHES))
    p.add_argument("--iters", type=int, default=ITERS, help="timed calls per step kind")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    gcfg, dcfg, hp = configs_512()
    g = Generator(gcfg, device=device, generator=torch.Generator().manual_seed(0))
    d = StyleDiscriminator(dcfg, generator=torch.Generator().manual_seed(1)).to(device)
    card = bench.card(device)
    rows = []
    with torch.enable_grad():
        for batch in args.batches:
            row = {**bench_batch(gcfg, dcfg, hp, g, d, batch, device, iters=args.iters),
                   "device": card}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
