#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sdface_gan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each printed as one JSON line; any failure raises and exits
non-zero with no ``ok`` line:

1. device  - nvidia-smi name and power limit, torch's device name and
             capability.  No CUDA: exit 2.  Run outside the repository
             (no ``sdface_gan_tpu_torch`` beside this file): exit 3.
2. build   - compile every CUDA source of the served paths
             (``csrc/siren_field.cu``, ``csrc/hash_grid.cu``) with one
             nvcc process each, all started together, unless a build for
             the source already exists; ptxas registers and spills.
3. kernel_check - each kernel against its plain PyTorch version on the card:
             * siren_field at full width (W=256, D=8, style 256, B=2,
               P=64*64*24) and at depth 3, P=700 (a partial tile), and at
               W=64 and W=512 (depth 3, P=700, partial tiles of 512 and 64
               points), in f32 (the register-blocked FMA kernel, max abs
               error <= 1e-3) and bf16 (tensor-core kernel: mean error
               against f32 truth <= 1.2x the plain bf16 version's + 1e-4;
               max abs against the plain bf16 version reported); the f32
               kernel also at W=64, 192, 256, 320, 512 (each tile geometry
               class), depth 3, P=1 and 700 (ragged tiles);
             * table_gather at the Pallas probe's shapes ([512, 128] f32,
               [8, 128] int32, one column) and at the packed NGP encode's
               (bf16, 64-wide rows, [2, 786432] indices): bit-equal;
             * hash_encode on the tuned and the upstream grid, std-1 tables,
               786,432 points with some outside the box and some on cell
               faces, and a real request's 786,432 points in the renderer's
               order: f32 max abs <= 1e-5, bf16 within one bf16 ulp
               (|d| <= 8e-3 |ref| + 1e-6); the packed encode through both
               kernels against the plain unpacked encode, f32, <= 1e-5.
4. serve   - the SIREN 256^2 generator (random weights from a seed) behind
             ``SDFaceSampler`` at batch 8, bf16 weights: warm up, zero the
             launch counts, answer two seed requests and one azim/elev
             request, read the counts (siren_field must have launched); a
             profiled request must show the bf16 tensor-core kernel
             (siren_field_mma_kernel) by name and not the f32 kernel
             (siren_field_f32_kernel);
             serve_compare: one f32 request with the fused field against the
             same request through the plain field (<= 2e-3), and the bf16
             request's mean error against that f32 plain image <= 1.2x the
             plain bf16 request's + 1e-4.
   serve_f32 - the same generator with f32 weights (the sampler's default
             for a state dict): three requests through the f32 kernel, a
             profiled one showing it by name and not the bf16 kernel,
             images/s.
5. serve_ngp - the same for the NGP generator of
             ``configs/256res/ffhq_256_sdf_ngp_tpu.yaml`` (tuned grid, tables
             packed at 64 MB): hash_encode and table_gather must each launch
             once per request and appear by name in the profile; then one
             request through the upstream grid (``ffhq_256_sdf_ngp.yaml``),
             which must launch hash_encode.  serve_ngp_compare: with the
             hash table redrawn with std 1, an f32 request with the kernels
             against the plain versions, and packed against unpacked
             (<= 2e-3 each).
6. timing  - at batch 8: each kernel's time (CUDA-event medians; the
             field's bf16 (mma) and f32 (FMA) kernels apart, with the sine
             epilogue's FP32-pipe time beside each bound; for the hash
             kernels, which are shorter than their wrappers' host work,
             the profiler's device time per launch, with the event time of a
             whole call beside it as ``call_ms``), its plain version's and,
             for table_gather, one PyTorch call's computing the same function,
             on the points of a real request; sampler images/s of both
             generators, and the f32 SIREN request's profiled device ms and
             images/s; beside the card's name and power limit.
7. train    - the training path (``sdface_gan_tpu_torch.training``), which
             runs no kernel of its own (the fused kernels have no backward):
             train_parity: a stage-A G step (eikonal), a stage-A D step
             (R1), a stage-B regularized D step and a path step, loss and
             every parameter gradient on the card against the CPU, same
             weights and inputs, f32 (batch 2, 16^2 thumbs, depth 3, width
             64, 64^2 decoder; loss rel <= 1e-4, each gradient's difference
             <= 1e-3 of its norm + 1e-6; the path step 1e-3 and 2e-2, see
             ``TRAIN_TOLERANCES``); train_eikonal_check: the f32
             subsampled eikonal term at full width at 64 points against
             central differences (h = 1e-7) of an f64 copy of the
             field (<= 1e-3 of the largest component; the f64 copy's own
             autograd term <= 1e-4); stage A of ``ffhq_256_sdf`` through
             ``train_volume_renderer``: 2 sphere-init steps and 3
             iterations under (a) the reference settings (f32, full
             eikonal, remat) and (b) ``ffhq_256_sdf_tpu`` (bf16 G
             parameters, 4096 eikonal points, no remat) and (a) without
             remat (what the checkpointing costs), one ``train`` line
             per logged step, D and G step medians after the first
             iteration, peak memory; stage B through ``train_full_pipeline``
             from (a)'s ``vol_renderer``: 3 iterations at 256^2, f32, the
             first with the regularized D and the path step, then both
             timed warm; train_profile: one stage-A G step and one D step
             profiled, the G step's top device operations.  Every loss is
             finite and siren_field never launches (counts and profiler).
8. train_cli - training from the command line, as a user runs it: 16
             procedural 320 x 288 PNG images through ``python -m
             sdface_gan_tpu_torch.prepare_data --size 256`` (records, store
             bytes, seconds; the native record-store and PNG library built
             by g++ first); the loader's work for 20 batches of 8 (decode,
             flip, HAMMING thumb) and the prefetching DataLoader's time per
             batch, beside the stage-A step time; ``python -m
             sdface_gan_tpu_torch.train --config
             configs/256res/ffhq_256_sdf_tpu.yaml --sdf 1`` at batch 8 (2
             sphere-init steps, 3 stage-A and 3 stage-B iterations): exit 0,
             both artifacts, finite losses, d_ms/g_ms logged, stage medians
             and wall time; the same command again trains nothing; a fresh
             experiment with ``--exit-after 1`` exits 3 leaving a
             ``models_*`` checkpoint, and the same command without it
             resumes at step + 1 and finishes.  Each command runs in a
             ``.chip_smoke_train_*`` directory with a ``configs`` symlink.
9. the ``kernels`` line, then the nvidia-smi line, then the ``ok`` line.
TF32 is off throughout, so every f32 reference really is f32: this process
turns it off, and the train entry turns it off in its own (train_cli checks
the line it prints).
"""

from __future__ import annotations

import argparse
import dataclasses
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
# f32 instructions per FiLM-sine evaluation in the field kernel's epilogue:
# bias add, FiLM fma, fast_sin (2 mul, rint, mul, sub, mul, 5 fma, mul), bf16 round
SINE_INSTRUCTIONS = 14
FIELD_DESIGN = {
    "bfloat16": "siren_field_mma_kernel<W>: mma.sync m16n8k16 bf16->f32 fed by ldmatrix, "
                "weights in a 2-stage cp.async ring of [64, W+8] K-chunks, 8 warps of "
                "64x64 output blocks per 128-point tile (W=256), bf16 activations in "
                "shared memory, FiLM-sine epilogue on the FP32 pipes",
    "float32": "siren_field_f32_kernel<W>: FMA pipes, f32 throughout; 8 warps, an 8-point x "
               "16-column register block (128 f32 accumulators) per thread over 128-point "
               "tiles (W=256), weights in a 2-stage cp.async ring of [32, W] f32 K-chunks, "
               "f32 activations in shared memory updated in place",
}

BATCH = 8
RES, SAMPLES, WIDTH, DEPTH, STYLE = 64, 24, 256, 8, 256
POINTS = RES * RES * SAMPLES
SOURCES = ("siren_field", "hash_grid")
NGP_BOUND = 2.0  # NGPSirenConfig.bound


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


def ngp_configs() -> dict:
    """The repository's two NGP configurations, resolved from their yaml files."""
    from sdface_gan_tpu_torch import configs

    return {"tuned": configs.ffhq_256_sdf_ngp_tpu(), "upstream": configs.ffhq_256_sdf_ngp()}


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


def bound(flops: float, nbytes: float, peak_flops: float) -> dict:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return dict(flops=flops, bytes=nbytes, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


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


def device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Mean device time of one launch of the kernel named ``kernel`` over
    ``iters`` calls of ``fn``, from the profiler's trace.  For kernels far
    shorter than their wrapper's host work, where events around a call
    would time the host.  The profiler can drop some device records of a
    session; the mean is over the launches it kept."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and kernel in ev.key:
            us = getattr(ev, "device_time_total", None)
            total_us += us if us is not None else ev.cuda_time_total
            count += ev.count
    check(0 < count <= iters, f"profiler saw {count} launches of {kernel} in {iters} calls")
    return total_us / count / 1e3


def field_inputs(net, b: int, p: int, seed: int):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    pts = torch.randn((b, p, 3), generator=g, device="cuda") * 0.5
    views = torch.nn.functional.normalize(
        torch.randn((b, p, 3), generator=g, device="cuda"), dim=-1)
    style = torch.randn((b, net.cfg.style_dim), generator=g, device="cuda")
    return pts, views, style


def check_field(depth: int, p: int, seed: int, width: int = WIDTH, bf16: bool = True) -> dict:
    """The field kernel against its plain version at one shape, f32 and
    (unless ``bf16`` is False) bf16."""
    import copy

    import torch

    from sdface_gan_tpu_torch.models.siren import SirenConfig, SirenGenerator
    from sdface_gan_tpu_torch.ops import siren_kernel as sk

    net32 = SirenGenerator(SirenConfig(depth=depth, width=width, style_dim=STYLE),
                           generator=torch.Generator().manual_seed(seed)).cuda()
    pts, views, style = field_inputs(net32, 2, p, seed)

    def run(net, fn):
        pack = sk.pack_siren_field(net)
        gamma, beta = sk.film_coeffs(net, style)
        rgb, sdf, feat = fn(pack, pts, views, gamma, beta)
        torch.cuda.synchronize()
        return torch.cat([rgb, sdf, feat.float()], -1)

    truth = run(net32, sk.siren_field_reference)
    kern32 = run(net32, sk.siren_field_fused_parts)
    err32 = (kern32 - truth).abs().max().item()
    check(bool(torch.isfinite(kern32).all()), "f32 field kernel output finite")
    check(err32 <= 1e-3, f"f32 field kernel vs plain: max abs err {err32} <= 1e-3")
    if not bf16:
        return dict(depth=depth, width=width, style=STYLE, batch=2, points=p,
                    f32_max_abs_err=err32)
    net16 = copy.deepcopy(net32).to(torch.bfloat16)
    plain16 = run(net16, sk.siren_field_reference)
    kern16 = run(net16, sk.siren_field_fused_parts)
    err16_kernel = (kern16 - truth).abs().mean().item()
    err16_plain = (plain16 - truth).abs().mean().item()
    rec = dict(depth=depth, width=width, style=STYLE, batch=2, points=p,
               f32_max_abs_err=err32, bf16_mean_err_kernel=err16_kernel,
               bf16_mean_err_plain=err16_plain,
               bf16_max_abs_kernel_vs_plain=(kern16 - plain16).abs().max().item())
    check(bool(torch.isfinite(kern16).all()), "bf16 field kernel output finite")
    check(err16_kernel <= 1.2 * err16_plain + 1e-4,
          f"bf16 field quality {err16_kernel} <= 1.2 * {err16_plain} + 1e-4")
    return rec


def check_table_gather() -> list:
    """Bit-equality with the plain version at the probe's and the packed
    encode's shapes."""
    import torch

    from sdface_gan_tpu_torch.ops import hash_encoder as hg

    g = torch.Generator(device="cuda").manual_seed(3)
    probe = torch.arange(512 * 128, dtype=torch.float32, device="cuda").reshape(512, 128)
    probe_idx = torch.randint(0, 512, (8, 128), generator=g, device="cuda", dtype=torch.int32)
    probe_idx[0, 0], probe_idx[-1, -1] = 0, 511
    rows = 73017  # the tuned grid's packed levels 0 and 1
    packed = torch.randn((rows, 64), generator=g, device="cuda").to(torch.bfloat16)
    packed_idx = torch.randint(0, rows, (2, BATCH * POINTS), generator=g, device="cuda",
                               dtype=torch.int32)
    recs = []
    for case, table, idx, ncols in (("probe", probe, probe_idx, 1),
                                    ("packed", packed, packed_idx, None)):
        got = hg.table_gather(table, idx, 0, ncols)
        want = hg.table_gather_reference(table, idx, 0, ncols)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        recs.append(dict(kernel="table_gather", case=case, table=list(table.shape),
                         dtype=str(table.dtype).split(".")[-1], idx=list(idx.shape),
                         out=list(got.shape), bit_equal=equal,
                         max_abs_err=(got.float() - want.float()).abs().max().item()))
        check(equal, f"table_gather {case}: bit-equal to the plain version")
    return recs


def grid_points(spec, n: int, seed: int):
    """n points: uniform a little beyond [-bound, bound] (some outside the
    box) and 64 per level on cell faces (x01 * scale + 0.5 integral)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    faces = []
    for lvl in range(spec.num_levels):
        scale = spec.level_scale(lvl)
        m = torch.randint(1, int(scale) + 1, (64, 3), generator=g, device="cuda").double()
        faces.append(((m - 0.5) / scale * 2.0 * NGP_BOUND - NGP_BOUND).float())
    k = n - 64 * spec.num_levels
    uniform = (torch.rand((k, 3), generator=g, device="cuda") * 2.0 - 1.0) * 1.1 * NGP_BOUND
    return torch.cat([uniform] + faces).contiguous()


def check_hash_encode() -> list:
    """Both grids, f32 and bf16 tables; the main path's level subset; the
    packed encode through both kernels.  Two point sets: uniform points with
    some outside the box and some on cell faces, and a real request's points
    in the renderer's order (the kernel's speed depends on their coherence,
    its result must not)."""
    import torch

    from sdface_gan_tpu_torch.ops import hash_encoder as hg

    recs = []
    for name, cfg in ngp_configs().items():
        net = cfg.renderer.network_config()
        spec = net.grid
        g = torch.Generator(device="cuda").manual_seed(11)
        table32 = torch.randn((spec.table_size, spec.level_dim), generator=g, device="cuda")
        subsets = [None]
        if net.pack_plan is not None:  # the unpacked levels, as the served path encodes them
            subsets.append(tuple(l for l in range(spec.num_levels)
                                 if l not in net.pack_plan.packed_levels))
        point_sets = {"uniform_and_faces": grid_points(spec, BATCH * POINTS, seed=12),
                      "request": request_points(cfg.renderer, seed=13)}
        for kind, x in point_sets.items():
            oob = (x.abs() > NGP_BOUND).any(-1).float().mean().item()
            for dtype in (torch.float32, torch.bfloat16):
                table = table32.to(dtype)
                for levels in subsets:
                    got = hg.hash_encode(x, table, spec, NGP_BOUND, levels=levels)
                    want = hg.hash_encode_reference(x, table, spec, NGP_BOUND, levels=levels)
                    torch.cuda.synchronize()
                    diff = (got.float() - want.float()).abs()
                    rec = dict(kernel="hash_encode", grid=name, points_kind=kind,
                               dtype=str(dtype).split(".")[-1],
                               levels=list(levels) if levels else "all", points=x.shape[0],
                               oob_share=oob, out=list(got.shape),
                               max_abs_err=diff.max().item(),
                               finite=bool(torch.isfinite(got).all()))
                    recs.append(rec)
                    check(rec["finite"], f"hash_encode {name} {kind} output finite")
                    if dtype == torch.float32:
                        check(rec["max_abs_err"] <= 1e-5, f"hash_encode {name} {kind} f32: "
                              f"max abs {rec['max_abs_err']} <= 1e-5")
                    else:
                        ok = bool((diff <= 8e-3 * want.float().abs() + 1e-6).all())
                        check(ok, f"hash_encode {name} {kind} bf16: within one bf16 ulp")
            if net.pack_plan is not None:
                plan = net.pack_plan
                packed = hg.pack_hash_table(table32, plan, dtype=torch.float32)
                got = hg.hash_encode_packed(x, table32, packed, plan, bound=NGP_BOUND)
                want = hg.hash_encode_reference(x, table32, spec, NGP_BOUND)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                recs.append(dict(kernel="hash_encode_packed", grid=name, points_kind=kind,
                                 dtype="float32", packed_levels=list(plan.packed_levels),
                                 max_abs_err=err))
                check(err <= 1e-5, f"packed encode through both kernels vs plain unpacked "
                      f"({kind}): {err}")
        del table32, point_sets, x
        torch.cuda.empty_cache()
    return recs


def drive(sampler, kernels) -> tuple:
    """Zero the counts, answer two seed requests and one azim/elev request,
    read the counts: each of ``kernels`` must have launched."""
    import torch

    from sdface_gan_tpu_torch.ops import _ext

    torch.cuda.synchronize()
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [sampler.sample(seed=1), sampler.sample(seed=2),
            sampler.sample(azim=0.2, elev=-0.1)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_ext.LAUNCHES)
    for name in kernels:
        check(launches[name] >= len(outs),
              f"kernel {name} launched in every request ({launches[name]} in {len(outs)})")
    size = sampler.cfg.size
    for img in outs:
        check(tuple(img.shape) == (BATCH, size, size, 3), f"image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), "image finite")
    check(not torch.equal(outs[0], outs[1]), "two seeds give two batches")
    return outs, launches, dt


def profile_request(sampler, kernel_names, absent=()) -> dict:
    """Kernel device times of one profiled request; each of ``kernel_names``
    must appear in it by name, and none of ``absent``.  The profiler can
    drop some device records of a session, so a request that misses a
    named kernel is profiled again, up to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sampler.sample(seed=3)
            torch.cuda.synchronize()
        device_us = {}  # kernels only: a CPU op's device time repeats its kernels'
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:
                continue
            us = getattr(ev, "device_time_total", None)
            device_us[ev.key] = us if us is not None else ev.cuda_time_total
        if all(any(kname in k for k in device_us) for kname in kernel_names):
            break
    total_us = sum(device_us.values())
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:12]
    named = {}
    for kname in kernel_names:
        named[kname] = sum(us for k, us in device_us.items() if kname in k) / 1e3
        check(named[kname] > 0, f"profiler shows {kname} inside a request")
    for kname in absent:
        check(not any(kname in k for k in device_us), f"profiler shows no {kname} in the request")
    return dict(device_events=len(device_us), device_ms_total=total_us / 1e3,
                kernel_ms=named, top=[(k[:90], us / 1e3) for k, us in top])


def images_per_s(sampler, n: int = 10) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        sampler.sample(seed=10 + i)
    torch.cuda.synchronize()
    return BATCH * n / (time.perf_counter() - t0)


def serve(results: dict) -> None:
    import torch

    from sdface_gan_tpu_torch.models import Generator
    from sdface_gan_tpu_torch.ops import siren_kernel as sk
    from sdface_gan_tpu_torch.serving import SDFaceSampler

    cfg = full_config()
    model = Generator(cfg, device="cuda",
                      generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    sampler = SDFaceSampler(model, batch=BATCH)
    sampler.warmup()
    outs, launches, dt = drive(sampler, ["siren_field"])
    results["launches"] = launches
    emit(phase="serve", requests=3, batch=BATCH, dtype="bfloat16", launches=launches,
         seconds_three_requests=dt,
         image_range=[min(o.min().item() for o in outs), max(o.max().item() for o in outs)])

    mma = sk.kernel_name(torch.bfloat16)
    prof = profile_request(sampler, [mma], absent=[sk.kernel_name(torch.float32)])
    results["profile"] = prof
    emit(phase="profile", device_events=prof["device_events"],
         device_ms_total=prof["device_ms_total"], kernel=mma,
         siren_field_kernel_ms=prof["kernel_ms"][mma])

    # one request in f32: fused field against the plain field; the bf16
    # request (seed 1, fused) held to the bf16 contract against that f32 image
    plain16 = SDFaceSampler(model, batch=BATCH, use_fused_kernel=False).sample(seed=1)
    model32 = Generator(cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    fused32 = SDFaceSampler(model32, batch=BATCH).sample(seed=1)
    plain32 = SDFaceSampler(model32, batch=BATCH, use_fused_kernel=False).sample(seed=1)
    err = (fused32 - plain32).abs().max().item()
    bf16_err = (outs[0].float() - plain32).abs().mean().item()
    bf16_plain_err = (plain16.float() - plain32).abs().mean().item()
    results["serve_f32_max_abs_err"] = err
    results["serve_bf16_mean_abs_err"] = dict(fused=bf16_err, plain=bf16_plain_err)
    # the decoder (f32 convs, TF32 off) carries the field's ~1e-5 summation-order
    # differences into the image; 2e-3 is the whole-image tolerance of the CPU tests
    check(err <= 2e-3, f"f32 request, fused vs plain field: max abs err {err} <= 2e-3")
    check(bf16_err <= 1.2 * bf16_plain_err + 1e-4,
          f"bf16 request vs f32 plain: mean abs {bf16_err} <= 1.2 * {bf16_plain_err} + 1e-4")
    emit(phase="serve_compare", f32_fused_vs_plain_max_abs_err=err, tolerance=2e-3,
         bf16_fused_request_vs_f32_plain_mean_abs_err=bf16_err,
         bf16_plain_request_vs_f32_plain_mean_abs_err=bf16_plain_err,
         bf16_tolerance="fused <= 1.2 x plain + 1e-4")
    results["images_per_s"] = images_per_s(sampler)


def serve_f32(results: dict) -> None:
    """The SIREN generator with f32 weights, as ``SDFaceSampler`` serves a
    state dict by default: the f32 field kernel's path.  Zero the counts,
    answer three requests, read the counts; a profiled request must show the
    f32 kernel by name and not the bf16 one; images/s."""
    import torch

    from sdface_gan_tpu_torch.models import Generator
    from sdface_gan_tpu_torch.ops import siren_kernel as sk
    from sdface_gan_tpu_torch.serving import SDFaceSampler

    model = Generator(full_config(), device="cuda", generator=torch.Generator().manual_seed(0))
    sampler = SDFaceSampler(model, batch=BATCH)
    sampler.warmup()
    outs, launches, dt = drive(sampler, ["siren_field"])
    f32 = sk.kernel_name(torch.float32)
    prof = profile_request(sampler, [f32], absent=[sk.kernel_name(torch.bfloat16)])
    results["f32_launches"] = launches
    results["f32_request"] = dict(device_ms_total=prof["device_ms_total"],
                                  kernel_ms=prof["kernel_ms"][f32], top=prof["top"],
                                  images_per_s=images_per_s(sampler))
    emit(phase="serve_f32", requests=3, batch=BATCH, dtype="float32", launches=launches,
         seconds_three_requests=dt, profile_device_ms_total=prof["device_ms_total"],
         kernel=f32, siren_field_kernel_ms=prof["kernel_ms"][f32],
         image_range=[min(o.min().item() for o in outs), max(o.max().item() for o in outs)])


def serve_ngp(results: dict) -> dict:
    """The tuned-grid NGP generator served in bf16, then one upstream-grid
    request; returns the served tuned model (for the timing phase)."""
    from dataclasses import replace

    import torch

    from sdface_gan_tpu_torch.models import Generator
    from sdface_gan_tpu_torch.serving import SDFaceSampler

    cfgs = ngp_configs()
    model = Generator(cfgs["tuned"], device="cuda",
                      generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    sampler = SDFaceSampler(model, batch=BATCH)
    check(model.renderer.network.encoder.packed is not None, "tuned grid packed at load")
    sampler.warmup()
    outs, launches, dt = drive(sampler, ["hash_encode", "table_gather"])
    results["ngp_launches"] = launches
    prof = profile_request(sampler, ["hash_encode_kernel", "table_gather_kernel"])
    results["ngp_profile"] = prof
    emit(phase="serve_ngp", config="ffhq_256_sdf_ngp_tpu", requests=3, batch=BATCH,
         dtype="bfloat16", launches=launches, seconds_three_requests=dt,
         image_range=[min(o.min().item() for o in outs), max(o.max().item() for o in outs)],
         profile_device_ms_total=prof["device_ms_total"], profile_kernel_ms=prof["kernel_ms"])

    up = Generator(cfgs["upstream"], device="cuda",
                   generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    up_sampler = SDFaceSampler(up, batch=BATCH)
    up_sampler.warmup()
    from sdface_gan_tpu_torch.ops import _ext

    torch.cuda.synchronize()
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    img = up_sampler.sample(seed=1)
    torch.cuda.synchronize()
    up_dt = time.perf_counter() - t0
    up_launches = dict(_ext.LAUNCHES)
    check(up_launches["hash_encode"] >= 1, "upstream grid: hash_encode launched")
    check(bool(torch.isfinite(img).all()) and tuple(img.shape) == (BATCH, 256, 256, 3),
          "upstream grid: finite image of the expected shape")
    results["ngp_upstream_launches"] = up_launches
    results["ngp_upstream_images_per_s"] = images_per_s(up_sampler, n=3)
    emit(phase="serve_ngp", config="ffhq_256_sdf_ngp", requests=1, batch=BATCH,
         dtype="bfloat16", launches=up_launches, seconds_one_request=up_dt)
    del up, up_sampler
    torch.cuda.empty_cache()

    # f32, hash table redrawn with std 1 (the init's +-1e-4 table would hide
    # the encode from the image): kernels vs plain versions, packed vs unpacked
    model32 = Generator(cfgs["tuned"], device="cuda", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        emb = model32.renderer.network.encoder.embeddings
        emb.copy_(torch.randn(emb.shape, generator=torch.Generator().manual_seed(5)))
    kern = SDFaceSampler(model32, batch=BATCH).sample(seed=1)
    plain = SDFaceSampler(model32, batch=BATCH, use_fused_kernel=False).sample(seed=1)
    rcfg = cfgs["tuned"].renderer
    unpacked_model = Generator(replace(cfgs["tuned"], renderer=replace(rcfg, ngp_pack_mb=0)),
                               device="cuda")
    unpacked_model.load_state_dict(model32.state_dict())
    unpacked = SDFaceSampler(unpacked_model, batch=BATCH).sample(seed=1)
    err = (kern - plain).abs().max().item()
    err_pack = (kern - unpacked).abs().max().item()
    results["ngp_serve_f32_max_abs_err"] = err
    check(err <= 2e-3, f"f32 NGP request, kernels vs plain: max abs err {err} <= 2e-3")
    check(err_pack <= 2e-3, f"f32 NGP request, packed vs unpacked: {err_pack} <= 2e-3")
    emit(phase="serve_ngp_compare", f32_kernels_vs_plain_max_abs_err=err,
         f32_packed_vs_unpacked_max_abs_err=err_pack, tolerance=2e-3,
         image_std=kern.std().item())
    del model32, unpacked_model
    torch.cuda.empty_cache()
    results["ngp_images_per_s"] = images_per_s(sampler)
    return model


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
        name = str(dtype).split(".")[-1]
        out[name] = dict(
            kernel=sk.kernel_name(dtype), design=FIELD_DESIGN[name],
            ms=ms, plain_ms=plain_ms, **bound(flops, field_bytes(pack, BATCH, POINTS), peak),
            tflops_achieved=flops / ms / 1e9)
        # the FiLM-sine epilogue on the FP32 pipes, not overlapped with the products
        evals = BATCH * POINTS * (DEPTH + 1) * WIDTH
        out[name]["sine_epilogue_fp32_ms"] = evals * SINE_INSTRUCTIONS / (PEAK_F32_FLOPS / 2) * 1e3
        del net, pts, views, args, pack
        torch.cuda.empty_cache()
    results["field_timing"] = out
    return out


def request_points(rcfg, seed: int):
    """The normalized sample points [B * P, 3] of one random-camera request,
    computed as ``render`` computes them."""
    import torch

    from sdface_gan_tpu_torch.geometry import generate_camera_params
    from sdface_gan_tpu_torch.geometry.rays import get_rays
    from sdface_gan_tpu_torch.models.renderer import _sample_z_vals

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cams = generate_camera_params(rcfg.out_im_res, gen, batch=BATCH, device="cuda")
    rays = get_rays(cams.focal, cams.extrinsics, rcfg.out_im_res)
    near = cams.near.reshape(BATCH, 1, 1, 1)
    far = cams.far.reshape(BATCH, 1, 1, 1)
    z = _sample_z_vals(rcfg, near, far, BATCH, gen)
    pts = rays.origins[..., None, :] + rays.directions[..., None, :] * z[..., None]
    return (pts * 2.0 / (far - near)[..., None]).reshape(-1, 3).contiguous()


def packed_indices(x, plan):
    """The packed-row indices [Lp, N] int32 of ``hash_encode_packed``."""
    import torch

    spec = plan.spec
    x01 = ((x + NGP_BOUND) / (2.0 * NGP_BOUND)).clamp(0.0, 1.0)
    rows = []
    for li, lvl in enumerate(plan.packed_levels):
        res = spec.level_resolution(lvl)
        pg = torch.floor(x01 * spec.level_scale(lvl) + 0.5).long()
        rows.append(pg[:, 0] + pg[:, 1] * res + pg[:, 2] * res * res + plan.row_offsets[li])
    return torch.stack(rows).to(torch.int32).contiguous()


def time_ngp_kernels(results: dict, tuned_model) -> dict:
    """Each hash kernel, its plain version and (table_gather) one PyTorch
    call, at batch 8 on a real request's points."""
    import torch

    from sdface_gan_tpu_torch.ops import hash_encoder as hg

    out = {}
    cfgs = ngp_configs()
    x = request_points(cfgs["tuned"].renderer, seed=21)
    n = x.shape[0]
    enc = tuned_model.renderer.network.encoder
    plan = cfgs["tuned"].renderer.network_config().pack_plan
    packed, table = enc.packed, enc.embeddings.detach()

    idx = packed_indices(x, plan)
    row_bytes = packed.shape[1] * packed.element_size()
    rows_read = torch.unique(idx).numel()
    gather_bytes = idx.numel() * 4 + rows_read * row_bytes + idx.numel() * row_bytes
    out["table_gather"] = dict(
        shape=dict(table=list(packed.shape), dtype=str(packed.dtype), idx=list(idx.shape)),
        ms=device_ms(lambda: hg.table_gather(packed, idx), "table_gather_kernel"),
        call_ms=cuda_ms(lambda: hg.table_gather(packed, idx), iters=20),
        plain_ms=cuda_ms(lambda: hg.table_gather_reference(packed, idx), iters=10),
        library_ms=cuda_ms(lambda: torch.index_select(packed, 0, idx.reshape(-1)), iters=20),
        rows_read=rows_read, **bound(0, gather_bytes, PEAK_F32_FLOPS))

    def encode_case(spec, tab, pts, levels):
        lv = levels or tuple(range(spec.num_levels))
        c, es = spec.level_dim, tab.element_size()
        table_bytes = sum(spec.level_table_size(l) for l in lv) * c * es
        nbytes = pts.numel() * 4 + pts.shape[0] * len(lv) * c * es + table_bytes
        flops = pts.shape[0] * len(lv) * 8 * (2 * c + 2)  # corner weights and sums
        return dict(
            levels=list(lv), dtype=str(tab.dtype).split(".")[-1], points=pts.shape[0],
            ms=device_ms(lambda: hg.hash_encode(pts, tab, spec, NGP_BOUND, levels),
                         "hash_encode_kernel"),
            call_ms=cuda_ms(lambda: hg.hash_encode(pts, tab, spec, NGP_BOUND, levels), iters=20),
            plain_ms=cuda_ms(lambda: hg.hash_encode_reference(pts, tab, spec, NGP_BOUND,
                                                              levels), iters=5, warmup=1),
            **bound(flops, nbytes, PEAK_F32_FLOPS))

    spec = plan.spec
    rest = tuple(l for l in range(spec.num_levels) if l not in plan.packed_levels)
    out["hash_encode"] = encode_case(spec, table, x, rest)  # the served path
    out["hash_encode_tuned_all_levels"] = encode_case(spec, table, x, None)
    up_spec = cfgs["upstream"].renderer.network_config().grid
    g = torch.Generator(device="cuda").manual_seed(22)
    up_table = (torch.rand((up_spec.table_size, up_spec.level_dim), generator=g,
                           device="cuda") * 2e-4 - 1e-4).to(torch.bfloat16)
    out["hash_encode_upstream"] = encode_case(up_spec, up_table, x, None)
    check(n == BATCH * POINTS, "timing at the served batch")
    results["ngp_timing"] = out
    return out


# ---------------------------------------------------------------------------
# Training (no kernel of its own: the fused kernels have no backward)
# ---------------------------------------------------------------------------

# (loss rel, gradient rel) of the card against the CPU: |l_cuda - l_cpu| <= a |l_cpu|,
# ||g_cuda - g_cpu|| <= b ||g_cpu|| + 1e-6 for every parameter.  The path step is
# looser: cuDNN runs the decoder's f32 convs with FFT algorithms (complex-f32 GEMM
# kernels in the profile), and the penalty, the squared norm of a gradient through 12
# modulated convs, amplifies their rounding (measured 3.6e-4 and 5.1e-3, H100).
TRAIN_TOLERANCES = {"stage_a_g": (1e-4, 1e-3), "stage_a_d_r1": (1e-4, 1e-3),
                    "stage_b_d_r1": (1e-4, 1e-3), "stage_b_path": (1e-3, 2e-2)}
EIKONAL_FD_RTOL = 1e-3  # f32 eikonal on the card vs f64 central differences, of max |grad|
# settings (a) reference parity, (b) TPU-tuned, and (a) with remat off
STAGE_A_BATCH = {"a": 8, "b": 8, "a_no_remat": 8}


def fake_loader(img_res: int, thumb_res: int, batch: int, seed: int = 0):
    """(img, thumb) batches in [-1, 1] from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    while True:
        yield (rng.uniform(-1, 1, (batch, img_res, img_res, 3)).astype(np.float32),
               rng.uniform(-1, 1, (batch, thumb_res, thumb_res, 3)).astype(np.float32))


def _grad_errors(loss_c, module_c, loss_h, module_h, params=None) -> dict:
    """Per-parameter ||g_cuda - g_cpu|| / ||g_cpu|| (with the 1e-6 floor)."""
    import torch

    names = [n for n, _ in module_c.named_parameters()
             if params is None or n.startswith(params)]
    pc = dict(module_c.named_parameters())
    ph = dict(module_h.named_parameters())
    gc = torch.autograd.grad(loss_c, [pc[n] for n in names], allow_unused=True)
    gh = torch.autograd.grad(loss_h, [ph[n] for n in names], allow_unused=True)
    out = {}
    for n, a, b in zip(names, gc, gh):
        a = torch.zeros_like(ph[n]) if a is None else a.cpu()
        b = torch.zeros_like(ph[n]) if b is None else b
        out[n] = ((a - b).norm().item(), b.norm().item())
    return out


def train_parity() -> dict:
    """One stage-A G step (eikonal), one stage-A D step (R1), one stage-B
    regularized D step and one path step, each as loss + gradients on the
    card and on the CPU from the same weights and inputs, f32, no jitter:
    batch 2, out_im_res 16, 24 samples, depth 3, width 64, style 64,
    decoder and D at 64^2 (channel base 128)."""
    import copy

    import torch

    from sdface_gan_tpu_torch.geometry import CameraParams, generate_camera_params
    from sdface_gan_tpu_torch.models import (
        Generator,
        GeneratorConfig,
        RendererConfig,
        StyleDiscConfig,
        StyleDiscriminator,
        VolumeRenderDiscConfig,
        VolumeRenderDiscriminator,
    )
    from sdface_gan_tpu_torch.training import steps

    style, res, batch = 64, 16, 2
    rkw = dict(type="sdf", out_im_res=res, n_samples=SAMPLES, style_dim=style, width=64,
               depth=3, force_background=False)
    cfg_a = GeneratorConfig(size=64, style_dim=style, full_pipeline=False,
                            renderer=RendererConfig(output_features=False, return_sdf=True,
                                                    **rkw))
    cfg_b = GeneratorConfig(size=64, style_dim=style, full_pipeline=True, freeze_renderer=True,
                            channel_base=128, renderer=RendererConfig(**rkw))
    vcfg = VolumeRenderDiscConfig(in_res=res)
    scfg = StyleDiscConfig(size=64, channel_multiplier=2, channel_base=128)
    hp = steps.TrainHParams(batch=batch, style_dim=style)
    seed = torch.Generator().manual_seed
    models = {"cpu": dict(ga=Generator(cfg_a, "cpu", seed(1)), gb=Generator(cfg_b, "cpu", seed(2)),
                          va=VolumeRenderDiscriminator(vcfg, seed(3)),
                          sb=StyleDiscriminator(scfg, seed(4)))}
    models["cuda"] = {k: copy.deepcopy(m).cuda() for k, m in models["cpu"].items()}
    gen = seed(5)
    z, z2 = torch.randn((batch, style), generator=gen), torch.randn((batch, style), generator=gen)
    cams = generate_camera_params(res, gen, batch=batch, device="cpu")
    thumbs = torch.rand((batch, res, res, 3), generator=gen) * 2 - 1
    imgs = torch.rand((batch, 64, 64, 3), generator=gen) * 2 - 1
    noise = torch.randn((batch, 64, 64, 3), generator=gen) / 64.0
    mean0 = torch.tensor(0.0)  # (pl - mean)^2 with mean ~ pl would amplify rounding

    def on(dev):
        m = models[dev]
        to = lambda t: t.to(dev)  # noqa: E731
        c = CameraParams(*map(to, cams))
        a_in = steps.StepInputs(to(z), c)
        b_in = steps.StepInputs(to(z), c, to(z2), 3, path_noise=to(noise))
        return {
            "stage_a_g": (steps.stage_a_g_loss(m["ga"], m["va"], cfg_a, vcfg, hp, a_in)[0],
                          m["ga"], None),
            "stage_a_d_r1": (steps.stage_a_d_loss(m["ga"], m["va"], cfg_a, vcfg, hp, to(thumbs),
                                                  a_in)[0], m["va"], None),
            "stage_b_d_r1": (steps.stage_b_d_loss(m["gb"], m["sb"], cfg_b, scfg, hp, to(imgs),
                                                  b_in, regularize=True)[0], m["sb"], None),
            "stage_b_path": (steps.stage_b_path_loss(m["gb"], cfg_b, hp, b_in, to(mean0))[0],
                             m["gb"], "decoder."),
        }

    with torch.enable_grad():
        cuda, cpu = on("cuda"), on("cpu")
        out, errors = {}, {}
        for name in cuda:
            (lc, mc, prefix), (lh, mh, _) = cuda[name], cpu[name]
            errors[name] = errs = _grad_errors(lc, mc, lh, mh, prefix)
            worst = max(errs, key=lambda n: errs[n][0] / (errs[n][1] + 1e-30))
            out[name] = dict(loss_cuda=lc.item(), loss_cpu=lh.item(),
                             loss_rel_err=abs(lc.item() - lh.item()) / max(abs(lh.item()), 1e-30),
                             params=len(errs), worst_param=worst,
                             worst_grad_rel_err=errs[worst][0] / (errs[worst][1] + 1e-30))
    emit(phase="train_parity", tolerances=TRAIN_TOLERANCES, **out)
    for name, rec in out.items():
        loss_tol, grad_tol = TRAIN_TOLERANCES[name]
        check(rec["loss_rel_err"] <= loss_tol,
              f"{name}: loss cuda vs cpu rel {rec['loss_rel_err']} <= {loss_tol}")
        for n, (e, s) in errors[name].items():
            check(e <= grad_tol * s + 1e-6, f"{name}: grad {n} cuda vs cpu {e} vs {s}")
    return out


def eikonal_fd_check(n: int = 64) -> dict:
    """The port's subsampled eikonal term on the card (f32, full width) at n
    frustum points against central differences of an f64 copy of the
    field's SDF (h = 1e-7), and the f64 copy's own autograd term too (<= 1e-4
    of the largest component: a wrong derivative is off by O(1); a step of
    1e-6 already crosses the polynomial sine's range-reduction seams, whose
    ~1e-7 jumps then show as 1e-5 of it)."""
    import copy

    import torch

    from sdface_gan_tpu_torch.geometry import generate_camera_params
    from sdface_gan_tpu_torch.models import RendererConfig, VolumeFeatureRenderer
    from sdface_gan_tpu_torch.models.renderer import _subsampled_eikonal, frustum_points

    cfg = RendererConfig(type="sdf", out_im_res=RES, n_samples=SAMPLES, style_dim=STYLE,
                         width=WIDTH, depth=DEPTH, output_features=False, eikonal_subsample=n,
                         remat=False)
    rend = VolumeFeatureRenderer(cfg, generator=torch.Generator().manual_seed(6)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(7)
    cams = generate_camera_params(RES, gen, batch=1, device="cuda")
    style = torch.randn((1, STYLE), generator=gen, device="cuda")
    u_uv = torch.rand((1, n, 2), generator=gen, device="cuda")
    u_t = torch.rand((1, n), generator=gen, device="cuda")
    near, far = cams.near.reshape(1, 1, 1, 1), cams.far.reshape(1, 1, 1, 1)
    with torch.enable_grad():
        eik = _subsampled_eikonal(rend, cfg, cams.focal, cams.extrinsics, near, far, style,
                                  draws=(u_uv, u_t)).detach().double()
    net64 = copy.deepcopy(rend.network).double()
    d = lambda t: t.double()  # noqa: E731
    pts = frustum_points(RES, d(cams.focal), d(cams.extrinsics), d(near), d(far), d(u_uv),
                         d(u_t))
    scale = 2.0 / (d(far) - d(near)).reshape(1, 1, 1)
    zeros = torch.zeros_like(pts)

    def sdf(p):
        return net64.forward_parts(p * scale, zeros, d(style))[1][..., 0]

    h = 1e-7
    fd = torch.stack([(sdf(pts + h * e) - sdf(pts - h * e)) / (2 * h)
                      for e in torch.eye(3, dtype=torch.float64, device="cuda")], -1)
    with torch.enable_grad():
        p = pts.clone().requires_grad_(True)
        (auto64,) = torch.autograd.grad(sdf(p).sum(), p)
    scale_fd = fd.abs().max().item()
    err32 = (eik - fd).abs().max().item()
    err64 = (auto64 - fd).abs().max().item()
    rec = dict(points=n, width=WIDTH, depth=DEPTH, fd_step=h, max_abs_grad=scale_fd,
               f32_card_vs_fd_max_abs_err=err32, f64_autograd_vs_fd_max_abs_err=err64,
               tolerance=f"{EIKONAL_FD_RTOL} x max |grad|",
               mean_grad_norm=fd.norm(dim=-1).mean().item())
    check(err32 <= EIKONAL_FD_RTOL * scale_fd, f"eikonal f32 vs finite differences: {err32}")
    check(err64 <= 1e-4 * scale_fd, f"eikonal f64 autograd vs finite differences: {err64}")
    return rec


def _train_rows(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _finite_losses(rows: list, what: str) -> None:
    import math

    for r in rows:
        for k, v in r.items():
            check(math.isfinite(v), f"{what}: {k} at step {r['step']} is finite")


def run_stage_a(setting: str, out_dir: str) -> dict:
    """2 sphere-init steps, then 3 stage-A iterations of the flagship at
    full width through ``train_volume_renderer``."""
    import torch

    from sdface_gan_tpu_torch import configs
    from sdface_gan_tpu_torch.ops import _ext
    from sdface_gan_tpu_torch.training import train_volume_renderer

    tpu = setting == "b"
    gcfg = configs.ffhq_256_sdf_tpu(stage_a=True) if tpu else configs.ffhq_256_sdf(stage_a=True)
    if setting == "a_no_remat":
        gcfg = dataclasses.replace(gcfg, renderer=dataclasses.replace(gcfg.renderer, remat=False))
    hp = configs.train_hparams(tpu=tpu, batch=STAGE_A_BATCH[setting])
    vcfg, _ = configs.discriminator_configs()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.enable_grad():
        train_volume_renderer(fake_loader(gcfg.size, gcfg.renderer.out_im_res, hp.batch),
                              gcfg, vcfg, hp, out_dir,
                              iters=3, sphere_init_iters=2, save_every=0, sample_every=0,
                              log_every=1, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rows = _train_rows(os.path.join(out_dir, "vol_render_metrics.jsonl"))
    _finite_losses(rows, f"stage A ({setting})")
    adv = [r for r in rows if "g" in r]
    check(len(adv) == 3, "3 stage-A iterations logged")
    for r in rows:
        emit(phase="train", run=f"stage_a_{setting}", **r)
    check(_ext.LAUNCHES["siren_field"] == 0, "no siren_field launch in training")
    rec = dict(setting=setting, batch=hp.batch, g_param_dtype=hp.g_param_dtype,
               eikonal_subsample=gcfg.renderer.eikonal_subsample, remat=gcfg.renderer.remat,
               d_ms=statistics.median(r["d_ms"] for r in adv[1:]),
               g_ms=statistics.median(r["g_ms"] for r in adv[1:]),
               first_iteration_ms=adv[0]["d_ms"] + adv[0]["g_ms"],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, seconds=seconds,
               siren_field_launches=_ext.LAUNCHES["siren_field"])
    return rec


def run_stage_b(vol_dir: str, out_dir: str) -> dict:
    """3 stage-B iterations at 256^2, f32, from stage A's ``vol_renderer``;
    iteration 0 takes the regularized D and the path step.  Then the warm
    regularized D and path steps timed on the trained models."""
    import torch

    from sdface_gan_tpu_torch import configs
    from sdface_gan_tpu_torch.models import Generator, StyleDiscriminator
    from sdface_gan_tpu_torch.ops import _ext
    from sdface_gan_tpu_torch.training import (
        stage_b_optimizers,
        train_full_pipeline,
    )
    from sdface_gan_tpu_torch.training.loop import _generator
    from sdface_gan_tpu_torch.training.steps import (
        sample_inputs,
        stage_b_d_step,
        stage_b_path_step,
    )
    from sdface_gan_tpu_torch.utils.checkpoints import load_checkpoint

    gcfg = configs.ffhq_256_sdf(stage_a=False)
    hp = configs.train_hparams(batch=BATCH)
    _, scfg = configs.discriminator_configs()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _ext.reset_launch_counts()
    with torch.enable_grad():
        train_full_pipeline(fake_loader(gcfg.size, gcfg.renderer.out_im_res, hp.batch),
                            gcfg, scfg, hp, out_dir,
                            vol_renderer_dir=vol_dir, iters=3, save_every=0, sample_every=0,
                            log_every=1, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    rows = _train_rows(os.path.join(out_dir, "full_pipeline_metrics.jsonl"))
    _finite_losses(rows, "stage B")
    check([r["step"] for r in rows] == [0, 1, 2], "3 stage-B iterations logged")
    check("r1" in rows[0] and "path" in rows[0], "iteration 0: regularized D and path step")
    for r in rows:
        emit(phase="train", run="stage_b", **r)

    ck = load_checkpoint(out_dir, "full_pipeline", map_location="cuda")
    g = Generator(gcfg, device="cuda")
    g.load_state_dict(ck["g"])
    d = StyleDiscriminator(scfg).cuda()
    d.load_state_dict(ck["d"])
    g_opt, d_opt = stage_b_optimizers(g, d)
    real = torch.rand((hp.batch, gcfg.size, gcfg.size, 3), device="cuda") * 2 - 1
    dev = torch.device("cuda")
    res, n_latent = gcfg.renderer.out_im_res, gcfg.decoder.n_latent
    mean = torch.zeros((), device="cuda")
    with torch.enable_grad():
        d_in = sample_inputs(hp, res, hp.batch, _generator(dev, 0, "smoke", "d"), n_latent)
        p_in = sample_inputs(hp, res, hp.batch // hp.path_batch_shrink,
                             _generator(dev, 0, "smoke", "p"), n_latent)
        reg_d_ms = cuda_ms(lambda: stage_b_d_step(g, d, d_opt, gcfg, scfg, hp, real, d_in,
                                                  regularize=True), iters=3, warmup=1)
        path_ms = cuda_ms(lambda: stage_b_path_step(g, g_opt, gcfg, hp, p_in, mean),
                          iters=3, warmup=1)
    check(_ext.LAUNCHES["siren_field"] == 0, "no siren_field launch in training")
    return dict(batch=hp.batch, path_batch=hp.batch // hp.path_batch_shrink,
                d_ms=statistics.median(r["d_ms"] for r in rows[1:]),
                g_ms=statistics.median(r["g_ms"] for r in rows[1:]),
                first_iteration=dict(reg_d_ms=rows[0]["d_ms"], g_ms=rows[0]["g_ms"],
                                     path_ms=rows[0]["path_ms"]),
                warm_reg_d_ms=reg_d_ms, warm_path_ms=path_ms, peak_memory_gb=peak,
                siren_field_launches=_ext.LAUNCHES["siren_field"])


def profile_train_step(vol_dir: str) -> dict:
    """One stage-A G step and one D step of setting (a), profiled: the top
    device operations of the G step, and no siren_field row in either."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdface_gan_tpu_torch import configs
    from sdface_gan_tpu_torch.models import Generator, VolumeRenderDiscriminator
    from sdface_gan_tpu_torch.training import stage_a_optimizers
    from sdface_gan_tpu_torch.training.loop import _frozen_copy, _generator
    from sdface_gan_tpu_torch.training.steps import sample_inputs, stage_a_d_step, stage_a_g_step
    from sdface_gan_tpu_torch.utils.checkpoints import load_checkpoint

    gcfg = configs.ffhq_256_sdf(stage_a=True)
    hp = configs.train_hparams(batch=STAGE_A_BATCH["a"])
    vcfg, _ = configs.discriminator_configs()
    ck = load_checkpoint(vol_dir, "vol_renderer", map_location="cuda")
    g = Generator(gcfg, device="cuda")
    g.load_state_dict(ck["g"])
    d = VolumeRenderDiscriminator(vcfg).cuda()
    d.load_state_dict(ck["d"])
    g_ema = _frozen_copy(g)
    g_opt, d_opt = stage_a_optimizers(g, d)
    dev = torch.device("cuda")
    res = gcfg.renderer.out_im_res
    real = torch.rand((hp.batch, res, res, 3), device="cuda") * 2 - 1
    inputs = sample_inputs(hp, res, hp.batch, _generator(dev, 0, "profile"))

    def g_step():
        stage_a_g_step(g, d, g_opt, g_ema, gcfg, vcfg, hp, inputs)

    def d_step():
        stage_a_d_step(g, d, d_opt, gcfg, vcfg, hp, real, inputs)

    out = {}
    with torch.enable_grad():
        g_step()
        d_step()
        torch.cuda.synchronize()
        for name, fn in (("g_step", g_step), ("d_step", d_step)):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                host_ms = (time.perf_counter() - t0) * 1e3
            dev_us = {}
            for ev in prof.key_averages():
                if ev.device_type == DeviceType.CUDA:
                    us = getattr(ev, "device_time_total", None)
                    dev_us[ev.key] = (us if us is not None else ev.cuda_time_total, ev.count)
            check(bool(dev_us), f"the {name} profile holds device events")
            check(not any("siren_field" in k for k in dev_us), f"no siren_field row in {name}")
            total = sum(us for us, _ in dev_us.values())
            top = sorted(dev_us.items(), key=lambda kv: -kv[1][0])[:15]
            out[name] = dict(host_ms=host_ms, device_ms_total=total / 1e3,
                             device_idle_share=max(0.0, 1 - total / 1e3 / host_ms),
                             kernels=len(dev_us),
                             top=[(k[:100], us / 1e3, n) for k, (us, n) in top])
    return out


def train(results: dict) -> None:
    """The training phase: parity on the card, the eikonal check, stage A
    under settings (a) and (b), stage B, the profile."""
    import tempfile

    parity = train_parity()
    eik = eikonal_fd_check()
    emit(phase="train_eikonal_check", **eik)
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_train_") as td:
        stage_a = {s: run_stage_a(s, os.path.join(td, f"stage_a_{s}")) for s in STAGE_A_BATCH}
        for s, rec in stage_a.items():
            emit(phase="train_stage_a", **rec)
        stage_b = run_stage_b(os.path.join(td, "stage_a_a"), os.path.join(td, "stage_b"))
        emit(phase="train_stage_b", **stage_b)
        prof = profile_train_step(os.path.join(td, "stage_a_a"))
        emit(phase="train_profile", setting="a", **prof)
    results["train"] = dict(parity=parity, eikonal=eik, stage_a=stage_a, stage_b=stage_b,
                            profile=prof)


# The train_cli phase: 16 procedural 320 x 288 images (the crop is exercised),
# the flagship's TPU-tuned settings from the command line at batch 8.
CLI_IMAGES, CLI_HW, CLI_SIZE, CLI_THUMB, CLI_BATCH = 16, (288, 320), 256, 64, 8
CLI_CONFIG, CLI_EXP = "configs/256res/ffhq_256_sdf_tpu.yaml", "ffhq256_sdf_tpu"
CLI_TRAIN_FLAGS = ("--batch", str(CLI_BATCH), "--sphere_init_iters", "2", "--log_every", "1",
                   "--save_every", "1000", "--sample_every", "1000")
CLI_TIMEOUT_S = 420


def procedural_images(n: int, hw: tuple, seed: int) -> list:
    """``n`` uint8 RGB images: smooth sinusoid fields plus Gaussian noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]] / max(hw)
    out = []
    for _ in range(n):
        f = rng.uniform(1, 6, (3, 2))
        phase = rng.uniform(0, 2 * np.pi, 3)
        smooth = np.stack([np.sin(2 * np.pi * (f[c, 0] * xx + f[c, 1] * yy) + phase[c])
                           for c in range(3)], -1)
        img = 127.5 + 100 * smooth + rng.normal(0, 8, smooth.shape)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def run_module(module: str, args: list, cwd: str, expect_rc: int = 0) -> dict:
    """``python -m sdface_gan_tpu_torch.<module> <args>`` in ``cwd`` with the
    checkout on the path; its exit code must be ``expect_rc``."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"sdface_gan_tpu_torch.{module}", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=CLI_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    check(proc.returncode == expect_rc,
          f"{module} {' '.join(args)} exited {proc.returncode}, expected {expect_rc}:\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return dict(rc=proc.returncode, seconds=seconds, stdout=proc.stdout)


def _tree_mtimes(root: str) -> dict:
    return {os.path.join(d, n): os.stat(os.path.join(d, n)).st_mtime_ns
            for d, _, names in os.walk(root) for n in names}


def _step_medians(rows: list) -> dict:
    """D and G medians after the first (warm-up) iteration."""
    adv = [r for r in rows if "g" in r][1:]
    return dict(d_ms=statistics.median(r["d_ms"] for r in adv),
                g_ms=statistics.median(r["g_ms"] for r in adv))


def train_cli(results: dict, smi: str) -> None:
    """The port's command-line training: a store prepared from PNG files by
    ``python -m sdface_gan_tpu_torch.prepare_data``, the loader timed on the
    host, ``python -m sdface_gan_tpu_torch.train`` through sphere init, stage A
    and stage B at full width, then the stage flow (a rerun trains nothing,
    ``--exit-after`` exits 3 and the next run resumes)."""
    import tempfile

    import numpy as np

    from sdface_gan_tpu_torch import native
    from sdface_gan_tpu_torch.data import DataLoader, MultiResolutionDataset
    from sdface_gan_tpu_torch.data.png import encode_png
    from sdface_gan_tpu_torch.utils.checkpoints import checkpoint_exists, latest_checkpoint_step

    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()  # leave the card's memory to the training subprocesses
    fresh = not native.library_path().exists()
    t0 = time.perf_counter()
    native.build()
    native_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(dir=HERE, prefix=".chip_smoke_train_") as td:
        os.symlink(os.path.join(HERE, "configs"), os.path.join(td, "configs"))
        os.makedirs(os.path.join(td, "imgs"))
        for i, img in enumerate(procedural_images(CLI_IMAGES, CLI_HW, seed=11)):
            with open(os.path.join(td, "imgs", f"{i:05d}.png"), "wb") as f:
                f.write(encode_png(img))
        store = os.path.join(td, "store")
        prep = run_module("prepare_data", ["imgs", "--out", "store", "--size", str(CLI_SIZE),
                                           "--n_worker", "8"], td)
        store_bytes = sum(os.path.getsize(os.path.join(store, n)) for n in os.listdir(store))
        ds = MultiResolutionDataset(store, CLI_SIZE, CLI_THUMB)
        records = len(ds)
        check(records == CLI_IMAGES, f"{records} records in the store")
        rec_store = dict(records=records, store_bytes=store_bytes, seconds=prep["seconds"],
                         native_build_s=native_s, native_built=fresh)
        emit(phase="train_cli_store", **rec_store)

        # the loader's work, synchronously (decode, flip, HAMMING thumb, stack)
        rng = np.random.default_rng(0)
        work_ms = []
        for b in range(20):
            t0 = time.perf_counter()
            items = [ds.__getitem__(int(i), rng)
                     for i in (np.arange(CLI_BATCH) + b * CLI_BATCH) % records]
            imgs, thumbs = np.stack([a for a, _ in items]), np.stack([t for _, t in items])
            work_ms.append((time.perf_counter() - t0) * 1e3)
        check(imgs.shape == (CLI_BATCH, CLI_SIZE, CLI_SIZE, 3) and thumbs.shape ==
              (CLI_BATCH, CLI_THUMB, CLI_THUMB, 3) and bool(np.isfinite(imgs).all()), "loader batch shapes")
        # and through the prefetching DataLoader, as the consumer sees it
        with DataLoader(ds, batch_size=CLI_BATCH, seed=0) as loader:
            it = iter(loader)
            next(it)
            t0 = time.perf_counter()
            for _ in range(20):
                next(it)
            loader_ms = (time.perf_counter() - t0) * 1e3 / 20
        ds.close()

        cmd = ["--config", CLI_CONFIG, "--sdf", "1", "--dataset_path", "store",
               "--iters", "3", *CLI_TRAIN_FLAGS]
        entry = run_module("train", cmd, td)
        check("precision: f32 matmuls and convolutions without TF32" in entry["stdout"],
              "the entry trains with TF32 off, as train_parity checks")
        out = os.path.join(td, "out", CLI_EXP)
        vr = os.path.join(out, "volume_renderer")
        check(checkpoint_exists(vr, "vol_renderer") and checkpoint_exists(out, "full_pipeline"),
              "both stage artifacts written")
        rows_a = _train_rows(os.path.join(vr, "vol_render_metrics.jsonl"))
        rows_b = _train_rows(os.path.join(out, "full_pipeline_metrics.jsonl"))
        _finite_losses(rows_a, "train_cli stage A")
        _finite_losses(rows_b, "train_cli stage B")
        check([r["step"] for r in rows_a if "g" in r] == [0, 1, 2]
              and [r["step"] for r in rows_b] == [0, 1, 2], "3 + 3 iterations logged")
        check(all("d_ms" in r and "g_ms" in r for r in rows_b + [r for r in rows_a if "g" in r]),
              "d_ms and g_ms logged")
        for r in rows_a + rows_b:
            emit(phase="train", run="train_cli", **r)
        stage_a, stage_b = _step_medians(rows_a), _step_medians(rows_b)
        step_a_ms = stage_a["d_ms"] + stage_a["g_ms"]
        rec_loader = dict(batch=CLI_BATCH, resolution=CLI_SIZE, thumb=CLI_THUMB,
                          batch_work_ms_median=statistics.median(work_ms),
                          loader_ms_per_batch=loader_ms, stage_a_step_ms=step_a_ms,
                          keeps_up=statistics.median(work_ms) < step_a_ms,
                          prefetch_threads=1)
        emit(phase="train_cli_loader", **rec_loader)
        rec_entry = dict(config=CLI_CONFIG, command_s=entry["seconds"], stage_a=stage_a,
                         stage_b=stage_b, sphere_init_iters=2, iters=3)
        emit(phase="train_cli_entry", **rec_entry)

        before = _tree_mtimes(out)
        rerun = run_module("train", cmd, td)
        check(_tree_mtimes(out) == before, "a rerun trains nothing")
        with open(os.path.join(td, "cut.yaml"), "w") as f:
            f.write(f"inherit_from: {CLI_CONFIG}\ntraining:\n  out_dir: out/smoke_cut\n")
        cut_cmd = ["--config", "cut.yaml", "--sdf", "1", "--dataset_path", "store",
                   "--iters", "6", *CLI_TRAIN_FLAGS]
        cut = run_module("train", cut_cmd + ["--exit-after", "1"], td, expect_rc=3)
        cut_vr = os.path.join(td, "out", "smoke_cut", "volume_renderer")
        cut_step = latest_checkpoint_step(cut_vr)
        check(cut_step is not None, "--exit-after left a models_* checkpoint")
        resume = run_module("train", cut_cmd, td)
        check(f"resumed volume renderer at step {cut_step + 1}" in resume["stdout"],
              "the next run resumed at step + 1")
        check(checkpoint_exists(os.path.join(td, "out", "smoke_cut"), "full_pipeline"),
              "the resumed run finished")
        rec_flow = dict(rerun_rc=rerun["rc"], rerun_s=rerun["seconds"], exit_after_rc=cut["rc"],
                        exit_after_step=cut_step, exit_after_s=cut["seconds"],
                        resume_rc=resume["rc"], resume_s=resume["seconds"])
        emit(phase="train_cli_flow", **rec_flow)
    results["train_cli"] = dict(store=rec_store, loader=rec_loader, entry=rec_entry,
                                flow=rec_flow)
    emit(phase="train_cli", nvidia_smi=smi, records=records, store_bytes=store_bytes,
         store_s=prep["seconds"], loader_ms_per_batch=loader_ms,
         batch_work_ms_median=rec_loader["batch_work_ms_median"], stage_a_step_ms=step_a_ms,
         loader_keeps_up=rec_loader["keeps_up"], entry_rc=entry["rc"],
         entry_s=entry["seconds"], stage_a=stage_a, stage_b=stage_b, rerun_rc=rerun["rc"],
         exit_after_rc=cut["rc"], resume_rc=resume["rc"])


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
    torch.set_grad_enabled(False)  # the kernels have no backward; training enables it

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

    built = {src: not _ext.library_path(src).exists() for src in SOURCES}
    t0 = time.perf_counter()
    _ext.build(*SOURCES)
    seconds = time.perf_counter() - t0
    for src in SOURCES:
        _ext.load(src)
        ptxas = [ln.strip() for ln in open(str(_ext.library_path(src)) + ".log")
                 if "registers" in ln or "spill" in ln or "Function properties" in ln]
        emit(phase="build", source=f"csrc/{src}.cu", seconds_all_sources=seconds,
             built=built[src], ptxas=ptxas)

    checks = [check_field(DEPTH, POINTS, seed=1), check_field(3, 700, seed=2),
              check_field(3, 700, seed=3, width=64), check_field(3, 700, seed=4, width=512)]
    # the f32 kernel at every tile geometry class, ragged tiles (P = 1, 700)
    f32_checks = [check_field(3, p, seed=5 + i, width=w, bf16=False)
                  for i, (w, p) in enumerate((w, p) for w in (64, 192, 256, 320, 512)
                                             for p in (1, 700))]
    for rec in checks + f32_checks:
        emit(phase="kernel_check", kernel="siren_field", **rec)
    results["field_checks"], results["field_f32_checks"] = checks, f32_checks
    gather_checks = check_table_gather()
    encode_checks = check_hash_encode()
    for rec in gather_checks + encode_checks:
        emit(phase="kernel_check", **rec)
    results["gather_checks"], results["encode_checks"] = gather_checks, encode_checks

    serve(results)
    serve_f32(results)
    ngp_model = serve_ngp(results)
    timing = time_field(results)
    ngp_timing = time_ngp_kernels(results, ngp_model)
    emit(phase="timing", nvidia_smi=smi, batch=BATCH, field=timing, ngp=ngp_timing,
         images_per_s=results["images_per_s"], ngp_images_per_s=results["ngp_images_per_s"],
         f32_images_per_s=results["f32_request"]["images_per_s"],
         f32_request_device_ms=results["f32_request"]["device_ms_total"],
         f32_request_kernel_ms=results["f32_request"]["kernel_ms"],
         ngp_upstream_images_per_s=results["ngp_upstream_images_per_s"])

    train(results)
    emit(phase="train_summary", nvidia_smi=smi,
         stage_a={k: {m: v[m] for m in ("batch", "d_ms", "g_ms", "peak_memory_gb")}
                  for k, v in results["train"]["stage_a"].items()},
         stage_b={m: results["train"]["stage_b"][m]
                  for m in ("d_ms", "g_ms", "warm_reg_d_ms", "warm_path_ms", "peak_memory_gb")})
    train_cli(results, smi)

    bf16, f32 = timing["bfloat16"], timing["float32"]
    gather, encode = ngp_timing["table_gather"], ngp_timing["hash_encode"]
    kernels = [
        dict(name="siren_field", route="cuda",
             source="sdface_gan_tpu_torch/ops/csrc/siren_field.cu",
             replaces="sdface_gan_tpu/ops/siren_kernel.py:40",
             kernel=bf16["kernel"], design=bf16["design"],
             launches=results["launches"]["siren_field"], checked=True,
             max_abs_err=checks[0]["bf16_max_abs_kernel_vs_plain"],
             f32_max_abs_err=checks[0]["f32_max_abs_err"],
             ms=bf16["ms"], plain_ms=bf16["plain_ms"], bound_ms=bf16["bound_ms"],
             bound_by=bf16["bound_by"], library_ms=None),
        dict(name="siren_field_f32", route="cuda",
             source="sdface_gan_tpu_torch/ops/csrc/siren_field.cu",
             replaces="sdface_gan_tpu/ops/siren_kernel.py:40",
             kernel=f32["kernel"], design=f32["design"],
             launches=results["f32_launches"]["siren_field"], checked=True,
             max_abs_err=max(r["f32_max_abs_err"] for r in checks + f32_checks),
             ms=f32["ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
             bound_by=f32["bound_by"], library_ms=None),
        dict(name="table_gather", route="cuda",
             source="sdface_gan_tpu_torch/ops/csrc/hash_grid.cu",
             replaces="scripts/bench_packed_gather.py:128",
             launches=results["ngp_launches"]["table_gather"], checked=True,
             max_abs_err=max(r["max_abs_err"] for r in gather_checks),
             ms=gather["ms"], plain_ms=gather["plain_ms"], bound_ms=gather["bound_ms"],
             bound_by=gather["bound_by"], library_ms=gather["library_ms"]),
        dict(name="hash_encode", route="cuda",
             source="sdface_gan_tpu_torch/ops/csrc/hash_grid.cu",
             replaces="sdface_gan_tpu/ops/hash_encoder.py:205",
             launches=results["ngp_launches"]["hash_encode"], checked=True,
             max_abs_err=max(r["max_abs_err"] for r in encode_checks
                             if r["dtype"] == "float32"),
             ms=encode["ms"], plain_ms=encode["plain_ms"], bound_ms=encode["bound_ms"],
             bound_by=encode["bound_by"], library_ms=None),
    ]
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
