#!/usr/bin/env python3
"""Time the stage-A G step with reverse- vs forward-mode eikonal on the card.

    python3 scripts/torch_bench_eikonal_mode.py [--batches 8 4 2] [--iters 5]
        [--field sdf|fc|ngp]

The port's counterpart of ``scripts/bench_eikonal_mode.py``: the stage-A G
step (``training.steps.stage_a_g_step``: the render with the full eikonal
term, the D's logits, the losses, the backward, Adam and the EMA) at 64² x
24 samples, width 256, depth 8, style 256, under ``(vjp, remat)``,
``(jvp, remat)`` and ``(jvp, no remat)``.  Random weights from a seed; one
warm-up step, then ``--iters`` timed steps, each timed by the host clock
between synchronisations.  Prints the card's name and power limit, then
one JSON line per configuration with the JAX script's keys
(``eikonal_mode``, ``remat``, ``batch``, ``g_step_ms`` (the median),
``it_per_s``, ``g_loss``) plus ``peak_memory_gb`` (the step's
``max_memory_allocated``) and ``device``.  A configuration that runs the
card out of memory (``torch.cuda.OutOfMemoryError``, nothing else) prints
an ``error`` line instead and the script goes on.  Exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = (("vjp", True), ("jvp", True), ("jvp", False))
FIELD_WIDTHS = {"sdf": dict(width=256, depth=8), "fc": dict(width=256, depth=8),
                "ngp": dict(width=256)}


def generator_config(eikonal_mode: str, remat: bool, field: str = "sdf", res: int = 64,
                     samples: int = 24, style: int = 256, widths=None):
    """The JAX script's generator: stage A (no decoder) at the flagship's
    widths, the mode and remat given."""
    from sdface_gan_tpu_torch.models import GeneratorConfig, RendererConfig

    widths = FIELD_WIDTHS[field] if widths is None else widths
    return GeneratorConfig(size=256, style_dim=style, full_pipeline=False,
                           renderer=RendererConfig(type=field, out_im_res=res,
                                                   n_samples=samples, style_dim=style,
                                                   eikonal_mode=eikonal_mode, remat=remat,
                                                   **widths))


def measure(eikonal_mode: str, remat: bool, batch: int, iters: int = 5, device: str = "cuda",
            gcfg=None, card: str = "") -> dict:
    """One configuration's line: the median G step, its rate, the last G
    loss and the peak memory; an ``error`` line on an out-of-memory."""
    import torch

    from sdface_gan_tpu_torch.models import (
        Generator,
        VolumeRenderDiscConfig,
        VolumeRenderDiscriminator,
    )
    from sdface_gan_tpu_torch.training import stage_a_optimizers
    from sdface_gan_tpu_torch.training.steps import TrainHParams, sample_inputs, stage_a_g_step

    gcfg = gcfg or generator_config(eikonal_mode, remat)
    res = gcfg.renderer.out_im_res
    dev = torch.device(device)
    line = dict(eikonal_mode=eikonal_mode, remat=remat, batch=batch,
                field=gcfg.renderer.type, device=card or dev.type)
    objects = []
    try:
        dcfg = VolumeRenderDiscConfig(in_res=res)
        hp = TrainHParams(batch=batch, style_dim=gcfg.style_dim)
        g = Generator(gcfg, device=dev, generator=torch.Generator().manual_seed(0))
        d = VolumeRenderDiscriminator(dcfg, generator=torch.Generator().manual_seed(1)).to(dev)
        g_ema = copy.deepcopy(g).requires_grad_(False)
        g_opt, _ = stage_a_optimizers(g, d)
        objects = [g, d, g_ema, g_opt]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        step_ms, m = [], None
        for i in range(1 + iters):
            inputs = sample_inputs(hp, res, batch, torch.Generator(device=dev).manual_seed(7 + i))
            t0 = time.perf_counter()
            with torch.enable_grad():
                m = stage_a_g_step(g, d, g_opt, g_ema, gcfg, dcfg, hp, inputs)
            g_loss = float(m["g"])  # synchronises
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if i:
                step_ms.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(step_ms)
        line.update(g_step_ms=ms, it_per_s=1e3 / ms, g_loss=g_loss, g_step_ms_all=step_ms)
        if dev.type == "cuda":
            line["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    except torch.cuda.OutOfMemoryError as e:
        line["error"] = f"{type(e).__name__}: {str(e)[:160]}"
        if dev.type == "cuda":
            line["peak_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    finally:
        del objects
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps(line), flush=True)
    return line


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[8, 4, 2])
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--field", default="sdf", choices=sorted(FIELD_WIDTHS))
    args = parser.parse_args()

    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("torch_bench_eikonal_mode: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for batch in args.batches:
        for mode, remat in CONFIGS:
            measure(mode, remat, batch, args.iters,
                    gcfg=generator_config(mode, remat, args.field), card=card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
