#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sdface_gan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each printed as one JSON line; any failure raises and exits
non-zero with no ``ok`` line:

1. device  - nvidia-smi name and power limit, torch's device name and
             capability.  No CUDA: exit 2.  Run outside the repository
             (no ``sdface_gan_tpu_torch`` beside this file): exit 3.
2. build   - compile the path's CUDA kernel (``csrc/siren_field.cu``) with
             nvcc, unless its build for this source already exists.
3. kernels - each kernel against its plain PyTorch version on the card:
             the FiLM-SIREN field at full width (W=256, D=8, style 256,
             B=2, P=64*64*24) and at depth 3, P=700 (a partial tile), in
             f32 (max abs error <= 1e-3) and bf16 (mean error against f32
             truth <= 1.2x the plain bf16 version's + 1e-4).
4. serve   - the full-width 256^2 generator (random weights from a seed)
             behind ``SDFaceSampler`` at batch 8 with bf16 weights: warm
             up, zero the launch counts, answer two seed requests and one
             azim/elev request, read the counts (every kernel must have
             launched); a profiled request must show the kernel by name;
             one request in f32 with the fused field against the same
             request through the plain field.
5. timing  - CUDA-event medians of each kernel and its plain version at
             batch 8, and sampler images/s, beside the card's name and
             power limit.
6. the ``kernels`` line, then the nvidia-smi line, then the ``ok`` line.
TF32 is off throughout, so every f32 reference really is f32.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (dense), used for each kernel's least time.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

BATCH = 8
RES, SAMPLES, WIDTH, DEPTH, STYLE = 64, 24, 256, 8, 256
POINTS = RES * RES * SAMPLES


def emit(**record) -> None:
    print(json.dumps(record), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def full_config():
    from sdface_gan_tpu_torch.models import GeneratorConfig, RendererConfig

    return GeneratorConfig(
        size=256, style_dim=STYLE, full_pipeline=True,
        renderer=RendererConfig(type="sdf", out_im_res=RES, n_samples=SAMPLES,
                                style_dim=STYLE, width=WIDTH, depth=DEPTH),
    )


def field_flops(depth: int, width: int) -> int:
    """Multiply-adds x 2 per point: 3->W, (D-1) WxW, W->1, (W+3)->W, W->3."""
    return 2 * (3 * width + (depth - 1) * width * width + width
                + (width + 3) * width + width * 3)


def field_bytes(pack, b: int, p: int) -> int:
    """Each input read once, each output written once."""
    weights = sum(t.numel() * t.element_size() for t in pack.tensors())
    inputs = 2 * b * p * 3 * 4 + 2 * b * (pack.depth + 1) * pack.width * 4
    outputs = b * p * (3 + 1) * 4 + b * p * pack.width * pack.w_first.element_size()
    return weights + inputs + outputs


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``iters`` event-timed runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def field_inputs(net, b: int, p: int, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    pts = torch.randn((b, p, 3), generator=g, device="cuda") * 0.5
    views = torch.nn.functional.normalize(
        torch.randn((b, p, 3), generator=g, device="cuda"), dim=-1)
    style = torch.randn((b, net.cfg.style_dim), generator=g, device="cuda")
    return pts, views, style


def check_field(depth: int, p: int, seed: int) -> dict:
    """The field kernel against its plain version at one shape, f32 and bf16."""
    import copy

    import torch

    from sdface_gan_tpu_torch.models.siren import SirenConfig, SirenGenerator
    from sdface_gan_tpu_torch.ops import siren_kernel as sk

    net32 = SirenGenerator(SirenConfig(depth=depth, width=WIDTH, style_dim=STYLE),
                           generator=torch.Generator().manual_seed(seed)).cuda()
    net16 = copy.deepcopy(net32).to(torch.bfloat16)
    pts, views, style = field_inputs(net32, 2, p, seed)

    def run(net, fn):
        pack = sk.pack_siren_field(net)
        gamma, beta = sk.film_coeffs(net, style)
        rgb, sdf, feat = fn(pack, pts, views, gamma, beta)
        torch.cuda.synchronize()
        return torch.cat([rgb, sdf, feat.float()], -1)

    truth = run(net32, sk.siren_field_reference)
    kern32 = run(net32, sk.siren_field_fused_parts)
    plain16 = run(net16, sk.siren_field_reference)
    kern16 = run(net16, sk.siren_field_fused_parts)
    err32 = (kern32 - truth).abs().max().item()
    err16_kernel = (kern16 - truth).abs().mean().item()
    err16_plain = (plain16 - truth).abs().mean().item()
    rec = dict(depth=depth, width=WIDTH, style=STYLE, batch=2, points=p,
               f32_max_abs_err=err32, bf16_mean_err_kernel=err16_kernel,
               bf16_mean_err_plain=err16_plain,
               bf16_max_abs_kernel_vs_plain=(kern16 - plain16).abs().max().item())
    check(bool(torch.isfinite(kern32).all() and torch.isfinite(kern16).all()),
          "field kernel output finite")
    check(err32 <= 1e-3, f"f32 field kernel vs plain: max abs err {err32} <= 1e-3")
    check(err16_kernel <= 1.2 * err16_plain + 1e-4,
          f"bf16 field quality {err16_kernel} <= 1.2 * {err16_plain} + 1e-4")
    return rec


def serve(results: dict) -> None:
    import torch

    from sdface_gan_tpu_torch.models import Generator
    from sdface_gan_tpu_torch.ops import _ext
    from sdface_gan_tpu_torch.serving import SDFaceSampler

    cfg = full_config()
    model = Generator(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    sampler = SDFaceSampler(model, batch=BATCH)
    sampler.warmup()
    torch.cuda.synchronize()

    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [sampler.sample(seed=1), sampler.sample(seed=2),
            sampler.sample(azim=0.2, elev=-0.1)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_ext.LAUNCHES)
    for name, n in launches.items():
        check(n >= 1, f"kernel {name} launched on the main path ({n} times)")
    for img in outs:
        check(tuple(img.shape) == (BATCH, 256, 256, 3), f"image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), "image finite")
    check(not torch.equal(outs[0], outs[1]), "two seeds give two batches")
    results["launches"] = launches
    emit(phase="serve", requests=3, batch=BATCH, dtype="bfloat16", launches=launches,
         seconds_three_requests=dt,
         image_range=[min(o.min().item() for o in outs), max(o.max().item() for o in outs)])

    # the kernel ran inside a request, by name, in the profiler's trace
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sampler.sample(seed=3)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    device_us = {}  # kernels only: a CPU op's device time repeats its kernels'
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "device_time_total", None)
        device_us[ev.key] = us if us is not None else ev.cuda_time_total
    total_us = sum(device_us.values())
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:12]
    field_us = sum(us for k, us in device_us.items() if "siren_field_kernel" in k)
    check(field_us > 0, "profiler shows siren_field_kernel inside a request")
    results["profile"] = dict(device_ms_total=total_us / 1e3, field_ms=field_us / 1e3,
                              top=[(k[:90], us / 1e3) for k, us in top])
    emit(phase="profile", device_events=len(device_us), device_ms_total=total_us / 1e3,
         siren_field_kernel_ms=field_us / 1e3)

    # one request in f32: fused field against the plain field
    model32 = Generator(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    fused32 = SDFaceSampler(model32, batch=BATCH).sample(seed=1)
    plain32 = SDFaceSampler(model32, batch=BATCH, use_fused_kernel=False).sample(seed=1)
    err = (fused32 - plain32).abs().max().item()
    bf16_err = (outs[0].float() - plain32).abs().mean().item()
    results["serve_f32_max_abs_err"] = err
    # the decoder (f32 convs, TF32 off) carries the field's ~1e-5 summation-order
    # differences into the image; 2e-3 is the whole-image tolerance of the CPU tests
    check(err <= 2e-3, f"f32 request, fused vs plain field: max abs err {err} <= 2e-3")
    emit(phase="serve_compare", f32_fused_vs_plain_max_abs_err=err, tolerance=2e-3,
         bf16_request_vs_f32_plain_mean_abs_err=bf16_err)

    n = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        sampler.sample(seed=10 + i)
    torch.cuda.synchronize()
    results["images_per_s"] = BATCH * n / (time.perf_counter() - t0)


def time_field(results: dict) -> dict:
    """Kernel and plain-version medians at batch 8, full width."""
    import copy

    import torch

    from sdface_gan_tpu_torch.models.siren import SirenConfig, SirenGenerator
    from sdface_gan_tpu_torch.ops import siren_kernel as sk

    net32 = SirenGenerator(SirenConfig(depth=DEPTH, width=WIDTH, style_dim=STYLE),
                           generator=torch.Generator().manual_seed(7)).cuda()
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        net = copy.deepcopy(net32).to(dtype)
        pts, views, style = field_inputs(net, BATCH, POINTS, 8)
        pack = sk.pack_siren_field(net)
        gamma, beta = sk.film_coeffs(net, style)
        args = (pack, pts, views, gamma, beta)
        ms = cuda_ms(lambda: sk.siren_field_fused_parts(*args), iters=10)
        plain_ms = cuda_ms(lambda: sk.siren_field_reference(*args), iters=5, warmup=1)
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
        flops = field_flops(DEPTH, WIDTH) * BATCH * POINTS
        nbytes = field_bytes(pack, BATCH, POINTS)
        t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        out[str(dtype).split(".")[-1]] = dict(
            ms=ms, plain_ms=plain_ms, flops=flops, bytes=nbytes,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            tflops_achieved=flops / ms / 1e9)
        del net, pts, views, args, pack
        torch.cuda.empty_cache()
    results["field_timing"] = out
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write every result to this JSON file")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "sdface_gan_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 3
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)  # inference only; the field kernel has no backward

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    results = dict(nvidia_smi=smi, device=name)
    emit(phase="device", nvidia_smi=smi, name=name,
         capability=list(torch.cuda.get_device_capability(0)),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    from sdface_gan_tpu_torch.ops import _ext

    # one source for now: build it in this process (parallel nvcc processes
    # come back with a second .cu file)
    built = not _ext.library_path("siren_field").exists()
    t0 = time.perf_counter()
    _ext.load("siren_field")
    ptxas = [ln.strip() for ln in open(str(_ext.library_path("siren_field")) + ".log")
             if "registers" in ln or "spill" in ln]
    emit(phase="build", kernel="siren_field", seconds=time.perf_counter() - t0,
         built=built, ptxas=ptxas)

    checks = [check_field(DEPTH, POINTS, seed=1), check_field(3, 700, seed=2)]
    for rec in checks:
        emit(phase="kernel_check", kernel="siren_field", **rec)
    results["field_checks"] = checks

    serve(results)
    timing = time_field(results)
    emit(phase="timing", nvidia_smi=smi, batch=BATCH, field=timing,
         images_per_s=results["images_per_s"])

    bf16 = timing["bfloat16"]
    kernels = [dict(
        name="siren_field", route="cuda",
        source="sdface_gan_tpu_torch/ops/csrc/siren_field.cu",
        replaces="sdface_gan_tpu/ops/siren_kernel.py:40",
        launches=results["launches"]["siren_field"], checked=True,
        max_abs_err=checks[0]["f32_max_abs_err"],
        ms=bf16["ms"], plain_ms=bf16["plain_ms"], bound_ms=bf16["bound_ms"],
        bound_by=bf16["bound_by"], library_ms=None,
    )]
    results["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
