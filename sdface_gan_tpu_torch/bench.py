"""Serving throughput bench of the port, port of the repository's ``bench.py``.

    python -m sdface_gan_tpu_torch.bench [--device cuda]

Images/s of the flagship full-pipeline generator forward (mapping ->
8-layer, 256-wide FiLM-SIREN volume renderer at 64^2 x 24 samples ->
StyleGAN2 decoder to 256^2; ``__graft_entry__.py:27-34``) at ``BATCH``,
random weights from a seeded ``torch.Generator`` cast to bf16 as
``bench.py:45-50`` casts them (the renderer keeps compositing in f32).  The
timed call is the serving path's own, ``SDFaceSampler.sample`` with no
truncation (the JAX bench's forward): the weights are packed once at the
sampler's construction, the field runs in the hand-written
``siren_field_mma_kernel<256>``, and only the 256^2 rgb is returned.

Each iteration is timed with CUDA events, the whole loop with a host clock
after ``torch.cuda.synchronize()``.  Prints one JSON line with
``bench.py``'s keys (``metric``, ``value`` in images/s, ``unit``,
``vs_baseline`` against the same estimated 2.5 images/s reference and its
note, ``mrays_per_sec``), plus the card (nvidia-smi name and power limit),
the per-iteration milliseconds (median and max: a single stalled
iteration shows in the max) and the kernels' launches in the timed loop.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from typing import Callable, Optional

import torch

from .models.generator import Generator, GeneratorConfig
from .models.renderer import RendererConfig
from .ops import _ext
from .serving import SDFaceSampler
from .utils.device import resolve_device

REFERENCE_H100_IMAGES_PER_SEC = 2.5
BATCH = 32
WARMUP = 2
ITERS = 10
TRUNCATION = 1.0  # the JAX bench's forward takes no truncation
# host idle at both ends of a profiler session, so that no launch sits at its edges
PROFILE_MARGIN_S = 0.05
METRIC = ("256x256 multi-view synthesis throughput (full SDF pipeline forward, batch {batch}, "
          "bf16 weights / f32 compositing, FiLM-SIREN field in the hand-written CUDA kernel "
          "siren_field_mma_kernel<256> (mma.sync bf16 tensor cores), StyleGAN2 decoder in "
          "cuDNN, PyTorch port)")
VS_BASELINE_NOTE = ("denominator is an ESTIMATED 2.5 img/s H100 torch reference (reference "
                    "repo publishes no throughput; see BASELINE.md)")


def flagship_config() -> GeneratorConfig:
    """The generator of ``__graft_entry__.entry``: 256^2, style 256, SIREN
    width 256, depth 8, 64^2 rays x 24 samples."""
    return GeneratorConfig(
        size=256, style_dim=256, full_pipeline=True,
        renderer=RendererConfig(type="sdf", out_im_res=64, n_samples=24, style_dim=256,
                                width=256, depth=8),
    )


def card(device: torch.device) -> str:
    """The card as ``nvidia-smi`` names it, with its power limit; ``cpu`` on the CPU."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_iterations(fn: Callable[[int], object], device: torch.device, iters: int) -> dict:
    """Run ``fn(i)`` for i < ``iters``, timing each iteration by CUDA events
    (the host clock on the CPU) and the loop by the host clock after a
    synchronise.  Returns the last output, the loop's seconds and the
    per-iteration milliseconds (all, median, max)."""
    synchronize(device)
    marks = []
    t0 = time.perf_counter()
    for i in range(iters):
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            out = fn(i)
            end.record()
            marks.append((start, end))
        else:
            t = time.perf_counter()
            out = fn(i)
            marks.append((t, time.perf_counter()))
    synchronize(device)
    seconds = time.perf_counter() - t0
    ms = [s.elapsed_time(e) if device.type == "cuda" else (e - s) * 1e3 for s, e in marks]
    return dict(out=out, seconds=seconds, iter_ms=ms, iter_ms_median=statistics.median(ms),
                iter_ms_max=max(ms))


def launches_since(before: dict) -> dict:
    """Each kernel's launches since the counts were ``before``."""
    return {k: v - before[k] for k, v in _ext.LAUNCHES.items()}


def kernel_device_ms(fn: Callable[[], object], kernel: str, calls: int = 20,
                     tries: int = 3) -> Optional[float]:
    """Mean device milliseconds of one launch of the CUDA kernel whose name
    holds ``kernel``, over ``calls`` calls of ``fn`` under the profiler.  For
    kernels far shorter than their wrapper's host work, where events around
    a call time the host.  The profiler can drop a session's device
    records (seen in short sessions whose first launch came at their
    start): each session idles ``PROFILE_MARGIN_S`` at both ends, and one
    that kept none of the kernel's is run again, up to ``tries`` sessions;
    None if none kept any.  ``fn`` launches the kernel
    at most once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S)
        total_us, count = 0.0, 0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and kernel in ev.key:
                us = getattr(ev, "device_time_total", None)
                total_us += us if us is not None else ev.cuda_time_total
                count += ev.count
        if count:
            if count > calls:
                raise RuntimeError(f"profiler saw {count} launches of {kernel} in {calls} calls")
            return total_us / count / 1e3
    return None


def serving_model(cfg: GeneratorConfig, device: torch.device, seed: int = 0,
                  dtype: torch.dtype = torch.bfloat16) -> Generator:
    """Random weights from a seeded ``torch.Generator``, cast to ``dtype``."""
    model = Generator(cfg, device=device, generator=torch.Generator().manual_seed(seed))
    return model.to(dtype).eval()


def run_bench(cfg: GeneratorConfig, batch: int, device="cuda", warmup: int = WARMUP,
              iters: int = ITERS, seed: int = 0) -> dict:
    """Time ``SDFaceSampler.sample`` of ``cfg`` at ``batch`` (one request,
    z and cameras from one seed, every iteration); returns the JSON record
    (``bench.py``'s keys and the port's additions)."""
    device = resolve_device(device)
    sampler = SDFaceSampler(serving_model(cfg, device, seed), batch=batch,
                            truncation=TRUNCATION, seed=seed)
    for _ in range(warmup):
        sampler.sample(seed=seed + 1)
    before = dict(_ext.LAUNCHES)  # count the timed loop's launches only
    t = time_iterations(lambda i: sampler.sample(seed=seed + 1), device, iters)
    launches = launches_since(before)
    rgb = t["out"]
    images_per_sec = batch * iters / t["seconds"]
    mrays_per_sec = images_per_sec * cfg.renderer.out_im_res ** 2 / 1e6
    return {
        "metric": METRIC.format(batch=batch),
        "value": round(images_per_sec, 3),
        "unit": "images/sec",
        "vs_baseline": round(images_per_sec / REFERENCE_H100_IMAGES_PER_SEC, 3),
        "vs_baseline_note": VS_BASELINE_NOTE,
        "mrays_per_sec": round(mrays_per_sec, 3),
        "device": card(device),
        "batch": batch,
        "iters": iters,
        "iter_ms_median": t["iter_ms_median"],
        "iter_ms_max": t["iter_ms_max"],
        "iter_ms": t["iter_ms"],
        "launches": launches,
        "finite": bool(torch.isfinite(rgb).all()),
        "shape": list(rgb.shape),
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="Serving throughput of the PyTorch port.")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = run_bench(flagship_config(), BATCH, args.device, WARMUP, ITERS)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
