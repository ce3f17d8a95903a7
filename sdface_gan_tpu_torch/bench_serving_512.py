"""512^2 serving throughput and memory fit of the port, port of
``scripts/bench_serving_512.py``.

    python -m sdface_gan_tpu_torch.bench_serving_512 [batches ...] [--device cuda]

The serving forward of ``configs/512res/ffhq_512_sdf_tpu.yaml`` (mapping ->
the 8-layer, 256-wide FiLM-SIREN volume renderer at 64^2 x 24 samples ->
StyleGAN2 decoder from 64^2 to 512^2, three doublings, ``n_latent`` 8),
resolved from the yaml through the port's own loader as ``train`` resolves
it (stage B), at batches 4, 8, 16 and 32 by default.  As ``bench`` serves:
random weights from a seeded ``torch.Generator`` cast to bf16, f32
compositing, the field in the hand-written ``siren_field_mma_kernel<256>``,
``SDFaceSampler.sample`` with no truncation timed (3 calls, then 10, each
timed by CUDA events and the loop by the host clock after a synchronise).

One JSON line per batch with the JAX script's keys (``bench``, ``batch``,
``img_per_s``, ``ms_per_batch``, ``fits_hbm``) plus ``peak_memory_gb``
(``torch.cuda.max_memory_allocated`` over that batch's sampler and calls),
the card, the per-call ms and the kernels' launches in the timed loop.
Only ``torch.cuda.OutOfMemoryError`` is a miss (``fits_hbm: false``); any
other error raises.
"""

from __future__ import annotations

import argparse
import gc
import json
import os

import torch

from . import bench
from .config import build, load_config
from .config.yaml_config import REPO_ROOT, default_config_path
from .models.generator import GeneratorConfig
from .ops import _ext
from .serving import SDFaceSampler
from .utils.device import resolve_device

CONFIG = "configs/512res/ffhq_512_sdf_tpu.yaml"
BATCHES = (4, 8, 16, 32)
WARMUP = 3
ITERS = 10
BENCH = "512x512 serving forward"


def config_512(stage_a: bool = False) -> GeneratorConfig:
    """The generator of ``CONFIG`` for one stage, as ``train`` resolves it."""
    cfg = load_config(os.path.join(REPO_ROOT, CONFIG), default_config_path())
    gcfg = build.generator_config(build.stage_options(cfg, stage_a), stage_a=stage_a)
    assert gcfg.size == 512, gcfg.size
    return gcfg


def peak_memory_gb(device: torch.device):
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def reset_peak(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def bench_batch(model, batch: int, device: torch.device, warmup: int = WARMUP,
                iters: int = ITERS, seed: int = 0) -> dict:
    """One batch's line: the sampler built for ``batch`` over ``model``, its
    calls timed; ``fits_hbm`` false on ``torch.cuda.OutOfMemoryError``."""
    row = {"bench": BENCH, "batch": batch}
    reset_peak(device)
    try:
        sampler = SDFaceSampler(model, batch=batch, truncation=bench.TRUNCATION, seed=seed)
        for _ in range(warmup):
            sampler.sample(seed=seed + 1)
        before = dict(_ext.LAUNCHES)  # the timed loop's launches only
        t = bench.time_iterations(lambda i: sampler.sample(seed=seed + 1), device, iters)
        rgb = t["out"]
        row.update(img_per_s=batch * iters / t["seconds"], ms_per_batch=1e3 * t["seconds"] / iters,
                   fits_hbm=True, peak_memory_gb=peak_memory_gb(device),
                   iter_ms_median=t["iter_ms_median"], iter_ms_max=t["iter_ms_max"],
                   launches=bench.launches_since(before), shape=list(rgb.shape),
                   finite=bool(torch.isfinite(rgb).all()))
        del sampler, rgb, t
    except torch.cuda.OutOfMemoryError as e:
        row.update(fits_hbm=False, error=str(e).splitlines()[0][:200])
    reset_peak(device)
    return row


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description="512^2 serving throughput of the PyTorch port.")
    p.add_argument("batches", type=int, nargs="*", default=list(BATCHES))
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = bench.serving_model(config_512(), device)
    card = bench.card(device)
    rows = []
    for batch in args.batches:
        row = {**bench_batch(model, batch, device), "device": card}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
