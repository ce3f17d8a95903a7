#!/usr/bin/env python3
"""Where the FiLM-SIREN field kernels' time goes, by ablation, on one GPU.

    python3 scripts/torch_siren_field_ablations.py [--out results.json]

Builds ``sdface_gan_tpu_torch/ops/csrc/siren_field.cu`` as it is and in
variants that each take one piece of work out of a kernel or change one
of its parameters (an ablation's outputs are wrong on purpose; it is
timed, not used).  ``siren_field_mma_kernel`` (bf16):

* ``no_sine``  - the FiLM result is stored without ``fast_sin``;
* ``no_mma``   - no ``mma.sync`` (ldmatrix, copies, epilogue stay);
* ``no_copy``  - no weight chunk is copied into the ring;
* ``stages3``  - a 3-stage weight ring instead of 2 (widths up to 256).

``siren_field_f32_kernel`` (f32), each built for W = 256 only:

* ``f32_no_sine``, ``f32_no_fma`` (no K loop), ``f32_no_copy`` - as above;
* ``f32_no_sync`` - no barrier or copy wait before a chunk inside a layer
  (a race: what the per-chunk synchronisation costs);
* ``f32_unroll1`` / ``f32_unroll2`` - the K loop unrolled 1 or 2 times
  (the kernel: the whole chunk, 8 at 32 rows);
* ``f32_ring3`` - 16-row chunks in a 3-stage ring (the kernel: 32 rows, 2);
* ``f32_tm4`` - 4-point register blocks (64 accumulators), 64-point tiles,
  16-row chunks, two blocks per SM.

Each variant is compiled with one ``nvcc`` (all started together) into
``.torch_ext_build/ablations/`` and called through the same C interface
as the port's wrapper, at the served shape: batch 8, 64 x 64 x 24 points
per element, width 256, depth 8, random weights from a seed (bf16 or f32,
as the variant's kernel takes).  The variants run in turns, two rounds,
each a CUDA-event median of 10 calls.  One JSON line per timing, then one
with every median and the card's nvidia-smi name and power limit.  Exits 2
without CUDA.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(HERE, "sdface_gan_tpu_torch", "ops", "csrc", "siren_field.cu")
BUILD = os.path.join(HERE, ".torch_ext_build", "ablations")
BATCH, POINTS, WIDTH, DEPTH, STYLE = 8, 64 * 64 * 24, 256, 8, 256

SINE = ("store_bf16x2(h + r * ld + col, fast_sin(fmaf(gg.x, z0 + bb.x, ee.x)),\n"
        "                     fast_sin(fmaf(gg.y, z1 + bb.y, ee.y)));")
NO_SINE = ("store_bf16x2(h + r * ld + col, fmaf(gg.x, z0 + bb.x, ee.x),\n"
           "                     fmaf(gg.y, z1 + bb.y, ee.y));")
MMA = '  asm volatile(\n      "mma.sync.aligned'
COPY = "  if (c < total) {\n    const int m = c / n_chunk"
RING = "constexpr int kStages = 2;"
WIDE = tuple((f"    case {w}: return launch_mma<{w}>(a, B, stream);\n", "")
             for w in (320, 384, 448, 512))
NO_F32 = tuple((f"    case {w}: return launch_f32<{w}>(a, B, stream);\n", "")
               for w in (64, 128, 192, 256, 320, 384, 448, 512))
NO_MMA = tuple((f"    case {w}: return launch_mma<{w}>(a, B, stream);\n", "")
               for w in (64, 128, 192, 256, 320, 384, 448, 512))
ONLY_F32_256 = NO_MMA + tuple(e for e in NO_F32 if "<256>" not in e[0])
F32_SINE = ("          fast_sin(fmaf(gg.x, z0 + bb.x, ee.x)), fast_sin(fmaf(gg.y, z1 + bb.y, ee.y)),\n"
            "          fast_sin(fmaf(gg.z, z2 + bb.z, ee.z)), fast_sin(fmaf(gg.w, z3 + bb.w, ee.w)));")
F32_NO_SINE = ("          fmaf(gg.x, z0 + bb.x, ee.x), fmaf(gg.y, z1 + bb.y, ee.y),\n"
               "          fmaf(gg.z, z2 + bb.z, ee.z), fmaf(gg.w, z3 + bb.w, ee.w));")
F32_LOOP = "#pragma unroll\n      for (int k = 0; k < kc; k += 4) {"
F32_SYNC = ("    cp_async_wait<G::kRing - 2>();  // this thread's part of chunk c has landed\n"
            "    __syncthreads();")
F32_NO_SYNC = "    if (kci == 0) __syncthreads();"
F32_COPY = "  if (c < total) {\n    const int mat = c / G::n_chunk"
F32_KC = "static constexpr int kc = W <= 384 ? 32 : 16;"
F32_RING = "static constexpr int kRing = 2;"
F32_TM = "static constexpr int kTM = 8;"
F32_BLOCKS = "constexpr int kF32BlocksPerSM = 1;"
VARIANTS = {  # name: (dot dtype, text edits)
    "as_is": ("bf16", NO_F32),
    "no_sine": ("bf16", ((SINE, NO_SINE),) + NO_F32),
    "no_mma": ("bf16", ((MMA, "  if (0) " + MMA[2:]),) + NO_F32),
    "no_copy": ("bf16", ((COPY, COPY.replace("c < total", "0")),) + NO_F32),
    "stages3": ("bf16", ((RING, RING.replace("2", "3")),) + WIDE + NO_F32),
    "f32_as_is": ("f32", ONLY_F32_256),
    "f32_no_sine": ("f32", ((F32_SINE, F32_NO_SINE),) + ONLY_F32_256),
    "f32_no_fma": ("f32", ((F32_LOOP, F32_LOOP.replace("for", "if (0) for")),) + ONLY_F32_256),
    "f32_no_copy": ("f32", ((F32_COPY, F32_COPY.replace("c < total", "0")),) + ONLY_F32_256),
    "f32_no_sync": ("f32", ((F32_SYNC, F32_NO_SYNC),) + ONLY_F32_256),
    "f32_unroll1": ("f32", ((F32_LOOP, F32_LOOP.replace("unroll", "unroll 1")),) + ONLY_F32_256),
    "f32_unroll2": ("f32", ((F32_LOOP, F32_LOOP.replace("unroll", "unroll 2")),) + ONLY_F32_256),
    "f32_ring3": ("f32", ((F32_KC, "static constexpr int kc = 16;"),
                          (F32_RING, F32_RING.replace("2", "3"))) + ONLY_F32_256),
    "f32_tm4": ("f32", ((F32_TM, F32_TM.replace("8", "4")),
                        (F32_KC, "static constexpr int kc = 16;"),
                        (F32_BLOCKS, F32_BLOCKS.replace("1", "2"))) + ONLY_F32_256),
}


def build(nvcc_flags, nvcc) -> dict:
    """Write and compile every variant, all nvcc processes at once."""
    src = open(SOURCE).read()
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name, (_, edits) in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:  # str.replace would edit every copy
                raise RuntimeError(f"variant {name}: the source holds {old!r} "
                                   f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        cu, so = os.path.join(BUILD, f"{name}.cu"), os.path.join(BUILD, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen([nvcc, *nvcc_flags, "-o", so, cu], text=True,
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(json.dumps(dict(variant=name, ptxas=ptxas[:2])), flush=True)
        fn = ctypes.CDLL(so).siren_field_forward
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 18 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the medians to this JSON file")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from sdface_gan_tpu_torch.models.siren import SirenConfig, SirenGenerator
    from sdface_gan_tpu_torch.ops import _ext
    from sdface_gan_tpu_torch.ops import siren_kernel as sk

    torch.set_grad_enabled(False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    fns = build(_ext.NVCC_FLAGS, _ext._nvcc())

    net32 = SirenGenerator(SirenConfig(depth=DEPTH, width=WIDTH, style_dim=STYLE),
                           generator=torch.Generator().manual_seed(7)).cuda()
    g = torch.Generator(device="cuda").manual_seed(8)
    pts = torch.randn((BATCH, POINTS, 3), generator=g, device="cuda") * 0.5
    views = torch.nn.functional.normalize(
        torch.randn((BATCH, POINTS, 3), generator=g, device="cuda"), dim=-1)
    style = torch.randn((BATCH, STYLE), generator=g, device="cuda")
    cases = {}
    for dot, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        net = copy.deepcopy(net32).to(dtype)
        pack = sk.pack_siren_field(net)
        gamma, beta = sk.film_coeffs(net, style)
        want = sk.siren_field_fused_parts(pack, pts, views, gamma, beta)[2]
        rgb = torch.empty(BATCH, POINTS, 3, device="cuda")
        sdf = torch.empty(BATCH, POINTS, 1, device="cuda")
        feat = torch.empty(BATCH, POINTS, WIDTH, dtype=dtype, device="cuda")
        ptrs = (pts.data_ptr(), views.data_ptr(), *(t.data_ptr() for t in pack.tensors()),
                gamma.data_ptr(), beta.data_ptr(), rgb.data_ptr(), sdf.data_ptr(),
                feat.data_ptr())
        cases[dot] = dict(keep=(pack, gamma, beta, rgb, sdf), want=want, feat=feat, ptrs=ptrs)

    def call(name, fn):
        dot = VARIANTS[name][0]
        code = fn(int(dot == "bf16"), *cases[dot]["ptrs"], BATCH, POINTS, DEPTH, WIDTH,
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"launch failed: CUDA error {code}")

    def median_ms(name, fn, iters=10):
        for _ in range(2):
            call(name, fn)
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(name, fn)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    medians = {}
    for rnd in range(2):
        for name, fn in fns.items():
            ms = median_ms(name, fn)
            medians.setdefault(name, []).append(ms)
            rec = dict(variant=name, round=rnd, ms=ms)
            if name in ("as_is", "f32_as_is"):  # the unablated build is the port's kernel
                case = cases[VARIANTS[name][0]]
                rec["feat_equal_to_wrapper"] = torch.equal(case["feat"], case["want"])
            print(json.dumps(rec), flush=True)
    result = dict(nvidia_smi=smi, batch=BATCH, points_per_element=POINTS, width=WIDTH,
                  depth=DEPTH, ms=medians)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
