"""NGP bench of the port, port of the repository's ``bench_ngp.py``.

    python -m sdface_gan_tpu_torch.bench_ngp [--device cuda]

Measures on the card, under the JAX bench's metric names:

1. ``bench_hash_fwd_bwd``: 393,216 points on the upstream grid (16 levels x
   2, T = 2^19, finest 4096): the forward (the hand-written ``hash_encode``
   kernel), the table gradient of ``sum(encode^2)`` through the encode's
   autograd ``Function`` (the kernel ``hash_encode_backward``, K1; the JAX
   line's name says "XLA scatter-add", which the port does not run), and
   the plain sort + segment-sum prototype ``hash_encode_vjp_sorted``, in
   Mlookups/s (points x levels x 8 corners per call).
2. ``bench_stage_a_ngp``: the stage-A NGP train step, D then G through
   ``training/steps.py``, batch 4, 64^2 x 24, the default (upstream) grid,
   remat; it/s and the per-iteration milliseconds (median, max).
3. ``bench_ngp_serving``: the 256^2 full pipeline on the NGP renderer at
   batch 8, bf16 weights, through ``SDFaceSampler.sample`` as ``bench``
   times it (``hash_encode``, and ``table_gather`` for packed levels), for
   the reference grid, the tuned grid and the tuned grid packed at 64 MB;
   images/s.

One JSON line per measurement, after a first line naming the card (the
JAX bench's ``{"devices": ...}``).  Each line carries the card, the
milliseconds per call or iteration, and the kernels' launches in its timed
loop.  Calls are timed with CUDA events around a loop of at least
``MIN_WINDOW_S`` seconds (the host's dispatch is inside, as in the JAX
bench's host clock); the hash-grid lines add the kernel's own device time
per launch, from the profiler.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import time
from typing import Optional

import numpy as np
import torch

from .bench import (
    TRUNCATION,
    card,
    kernel_device_ms,
    launches_since,
    serving_model,
    synchronize,
    time_iterations,
)
from .models.discriminator import VolumeRenderDiscConfig, VolumeRenderDiscriminator
from .models.generator import Generator, GeneratorConfig
from .models.renderer import RendererConfig
from .ops import _ext
from .ops.hash_encoder import HashGridSpec, hash_encode, hash_encode_vjp_sorted
from .serving import SDFaceSampler
from .training.optim import stage_a_optimizers
from .training.steps import TrainHParams, sample_inputs, stage_a_d_step, stage_a_g_step
from .utils.device import resolve_device

HASH_POINTS = 393216
MIN_WINDOW_S = 0.5  # a timed loop of calls lasts at least this long
# the JAX bench's metric names (the table gradient's keeps its "XLA" name)
HASH_METRICS = {
    "forward": "ngp hash_encode forward ({levels} levels x 8 corners)",
    "table_grad": "ngp table-grad backward, XLA scatter-add",
    "sorted": "ngp table-grad backward, sort+segment-sum prototype",
}
STAGE_A_METRIC = "stage-A NGP train step (D+G, batch {batch}, {res}^2x{samples})"
SERVING_METRIC = "ngp serving 256^2 full pipeline, {name}"
SERVING_GRIDS = {
    "reference 16xdim2 T=2^19 finest4096": dict(
        ngp_num_levels=16, ngp_level_dim=2, ngp_finest_res=4096, ngp_log2_hashmap_size=19),
    "tuned 4xdim8 T=2^15 finest256": dict(
        ngp_num_levels=4, ngp_level_dim=8, ngp_finest_res=256, ngp_log2_hashmap_size=15),
    "tuned 4xdim8 + packed 64MB": dict(
        ngp_num_levels=4, ngp_level_dim=8, ngp_finest_res=256, ngp_log2_hashmap_size=15,
        ngp_pack_mb=64),
}


def emit(record: dict) -> dict:
    print(json.dumps(record), flush=True)
    return record


def timed_calls(fn, device: torch.device, iters: int = 5,
                min_seconds: float = MIN_WINDOW_S) -> dict:
    """Milliseconds per call of ``fn`` (``bench_ngp.py``'s ``timeit``) over
    at least ``iters`` calls and at least ``min_seconds``, after two warm-up
    calls: one more call on the host clock sets the count, then CUDA events
    (the host clock on the CPU) time the loop.  Returns the milliseconds,
    the count, the last output and the kernels' launches in the timed
    calls."""
    for _ in range(2):
        fn()
    synchronize(device)
    t0 = time.perf_counter()
    fn()
    synchronize(device)
    calls = max(iters, math.ceil(min_seconds / max(time.perf_counter() - t0, 1e-6)))
    before = dict(_ext.LAUNCHES)

    def loop(_):
        for _ in range(calls):
            out = fn()
        return out

    t = time_iterations(loop, device, 1)
    return dict(out=t["out"], ms=t["iter_ms"][0] / calls, calls=calls,
                launches=launches_since(before))


def hash_inputs(spec: HashGridSpec, n_points: int, device, seed: int = 0,
                std: float = 1e-4):
    """Points ~ U(-1, 1)^3 and a table ~ U(-std, std) (the init's range),
    drawn by numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    table = rng.uniform(-std, std, (spec.table_size, spec.level_dim)).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (n_points, 3)).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(table).to(device)


def hash_functions(x: torch.Tensor, table: torch.Tensor, spec: HashGridSpec) -> dict:
    """The three timed functions: the forward, the table gradient of
    ``sum(encode^2)`` through autograd, and the sorted prototype with the
    forward's output as the cotangent."""
    def forward():
        with torch.no_grad():
            return hash_encode(x, table, spec)

    def table_grad():
        with torch.enable_grad():
            t = table.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad((hash_encode(x, t, spec) ** 2).sum(), t)
        return grad

    cotangent = forward()

    def sorted_prototype():
        with torch.no_grad():
            return hash_encode_vjp_sorted(x, table, spec, cotangent)

    return dict(forward=forward, table_grad=table_grad, sorted=sorted_prototype)


def bench_hash_fwd_bwd(n_points: int = HASH_POINTS, device="cuda",
                       spec: Optional[HashGridSpec] = None, iters: int = 5) -> list:
    device = resolve_device(device)
    spec = spec or HashGridSpec.create(desired_resolution=4096)
    x, table = hash_inputs(spec, n_points, device)
    fns = hash_functions(x, table, spec)
    lookups = n_points * spec.num_levels * 2 ** spec.input_dim
    dev = card(device)
    fwd = timed_calls(fns["forward"], device, iters)
    bwd = timed_calls(fns["table_grad"], device, iters)
    srt = timed_calls(fns["sorted"], device, iters)
    on_card = device.type == "cuda"
    fwd_kernel_ms = kernel_device_ms(fns["forward"], "hash_encode_kernel") if on_card else None
    k1_ms = (kernel_device_ms(fns["table_grad"], "hash_encode_backward_kernel") if on_card
             else None)
    return [
        emit({"metric": HASH_METRICS["forward"].format(levels=spec.num_levels),
              "value": round(lookups / fwd["ms"] / 1e3, 1), "unit": "Mlookups/sec",
              "points_per_sec": round(n_points / fwd["ms"] / 1e3, 2),
              "ms": fwd["ms"], "calls": fwd["calls"], "kernel": "hash_encode",
              "kernel_device_ms": fwd_kernel_ms, "device": dev,
              "launches": fwd["launches"]}),
        emit({"metric": HASH_METRICS["table_grad"],
              "value": round(lookups / bwd["ms"] / 1e3, 1), "unit": "Mlookups/sec",
              "vs_forward": round(bwd["ms"] / fwd["ms"], 2), "ms": bwd["ms"],
              "calls": bwd["calls"],
              "kernel": "hash_encode + hash_encode_backward (K1), through the autograd "
                        "Function; the port runs no XLA scatter-add",
              "kernel_device_ms": k1_ms,
              "device": dev, "launches": bwd["launches"]}),
        emit({"metric": HASH_METRICS["sorted"],
              "value": round(lookups / srt["ms"] / 1e3, 1), "unit": "Mlookups/sec",
              "vs_scatter": round(bwd["ms"] / srt["ms"], 2), "ms": srt["ms"],
              "calls": srt["calls"],
              "kernel": "none: the plain hash_encode_vjp_sorted (torch.sort + segment_reduce)",
              "device": dev, "launches": srt["launches"]}),
    ]


def stage_a_ngp_config() -> GeneratorConfig:
    """``bench_ngp.py``'s stage-A generator: 64^2 x 24, style 256, the NGP
    field at its default (upstream) grid, remat."""
    return GeneratorConfig(
        size=64, style_dim=256, full_pipeline=False,
        renderer=RendererConfig(type="ngp", out_im_res=64, n_samples=24, style_dim=256,
                                remat=True),
    )


def bench_stage_a_ngp(batch: int = 4, device="cuda", gcfg: Optional[GeneratorConfig] = None,
                      warmup: int = 2, iters: int = 5) -> dict:
    device = resolve_device(device)
    gcfg = gcfg or stage_a_ngp_config()
    res = gcfg.renderer.out_im_res
    dcfg = VolumeRenderDiscConfig(in_res=res)
    hp = TrainHParams(batch=batch, style_dim=gcfg.style_dim)
    g = Generator(gcfg, device=device, generator=torch.Generator().manual_seed(0))
    d = VolumeRenderDiscriminator(dcfg, generator=torch.Generator().manual_seed(1)).to(device)
    g_ema = copy.deepcopy(g).requires_grad_(False)
    g_opt, d_opt = stage_a_optimizers(g, d)
    gen = torch.Generator(device=device).manual_seed(2)
    reals = torch.rand((batch, res, res, 3), generator=gen, device=device) * 2 - 1
    losses = []

    def one_iter(i: int):
        with torch.enable_grad():
            d_in = sample_inputs(hp, res, batch, torch.Generator(device=device).manual_seed(
                7 + 2 * i))
            g_in = sample_inputs(hp, res, batch, torch.Generator(device=device).manual_seed(
                8 + 2 * i))
            stage_a_d_step(g, d, d_opt, gcfg, dcfg, hp, reals, d_in)
            m = stage_a_g_step(g, d, g_opt, g_ema, gcfg, dcfg, hp, g_in)
        losses.append(m["g"])
        return m

    for i in range(warmup):
        one_iter(i)
    synchronize(device)
    before = dict(_ext.LAUNCHES)
    t = time_iterations(lambda i: one_iter(warmup + i), device, iters)
    launches = launches_since(before)
    return emit({
        "metric": STAGE_A_METRIC.format(batch=batch, res=res, samples=gcfg.renderer.n_samples),
        "value": round(iters / t["seconds"], 3), "unit": "it/sec",
        "iter_ms_median": t["iter_ms_median"], "iter_ms_max": t["iter_ms_max"],
        "iter_ms": t["iter_ms"], "device": card(device), "launches": launches,
        "finite": all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in losses)})


def ngp_serving_config(grid: dict, size: int = 256, style_dim: int = 256) -> GeneratorConfig:
    return GeneratorConfig(
        size=size, style_dim=style_dim, full_pipeline=True,
        renderer=RendererConfig(type="ngp", out_im_res=64, n_samples=24,
                                style_dim=style_dim, **grid))


def bench_ngp_serving(batch: int = 8, device="cuda", configs: Optional[dict] = None,
                      iters: int = 5) -> list:
    device = resolve_device(device)
    configs = configs or {name: ngp_serving_config(grid) for name, grid in SERVING_GRIDS.items()}
    records = []
    for name, gcfg in configs.items():
        sampler = SDFaceSampler(serving_model(gcfg, device), batch=batch,
                                truncation=TRUNCATION)
        t = timed_calls(lambda: sampler.sample(seed=1), device, iters)
        records.append(emit({
            "metric": SERVING_METRIC.format(name=name), "batch": batch,
            "value": round(batch / t["ms"] * 1e3, 1), "unit": "images/sec",
            "ms": t["ms"], "calls": t["calls"], "device": card(device),
            "launches": t["launches"], "finite": bool(torch.isfinite(t["out"]).all())}))
        del sampler
    return records


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description="NGP bench of the PyTorch port.")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = [emit({"devices": [card(device)],
                     "torch_device": (torch.cuda.get_device_name(device)
                                      if device.type == "cuda" else "cpu")})]
    records += bench_hash_fwd_bwd(device=device)
    records.append(bench_stage_a_ngp(device=device))
    records += bench_ngp_serving(device=device)
    return records


if __name__ == "__main__":
    main()
