#!/usr/bin/env python3
"""Where the bf16 FiLM-SIREN field kernel's time goes, by ablation, on one GPU.

    python3 scripts/torch_siren_field_ablations.py [--out results.json]

Builds ``sdface_gan_tpu_torch/ops/csrc/siren_field.cu`` as it is and in
variants that each take one piece of work out of ``siren_field_mma_kernel``
(their outputs are wrong on purpose; they are timed, not used):

* ``no_sine``  - the FiLM result is stored without ``fast_sin``;
* ``no_mma``   - no ``mma.sync`` (ldmatrix, copies, epilogue stay);
* ``no_copy``  - no weight chunk is copied into the ring;
* ``stages3``  - a 3-stage weight ring instead of 2 (widths up to 256).

Each variant is compiled with one ``nvcc`` (all started together) into
``.torch_ext_build/ablations/`` and called through the same C interface
as the port's wrapper, at the served shape: batch 8, 64 x 64 x 24 points
per element, width 256, depth 8, random bf16 weights from a seed.  The
variants run in turns, two rounds, each a CUDA-event median of 10 calls.
One JSON line per timing, then one with every median and the card's
nvidia-smi name and power limit.  Exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
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
VARIANTS = {
    "as_is": (),
    "no_sine": ((SINE, NO_SINE),),
    "no_mma": ((MMA, "  if (0) " + MMA[2:]),),
    "no_copy": ((COPY, COPY.replace("c < total", "0")),),
    "stages3": ((RING, RING.replace("2", "3")),) + WIDE,
}


def build(nvcc_flags, nvcc) -> dict:
    """Write and compile every variant, all nvcc processes at once."""
    src = open(SOURCE).read()
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
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

    net = SirenGenerator(SirenConfig(depth=DEPTH, width=WIDTH, style_dim=STYLE),
                         generator=torch.Generator().manual_seed(7)).cuda().to(torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(8)
    pts = torch.randn((BATCH, POINTS, 3), generator=g, device="cuda") * 0.5
    views = torch.nn.functional.normalize(
        torch.randn((BATCH, POINTS, 3), generator=g, device="cuda"), dim=-1)
    style = torch.randn((BATCH, STYLE), generator=g, device="cuda")
    pack = sk.pack_siren_field(net)
    gamma, beta = sk.film_coeffs(net, style)
    want = sk.siren_field_fused_parts(pack, pts, views, gamma, beta)[2]
    rgb = torch.empty(BATCH, POINTS, 3, device="cuda")
    sdf = torch.empty(BATCH, POINTS, 1, device="cuda")
    feat = torch.empty(BATCH, POINTS, WIDTH, dtype=torch.bfloat16, device="cuda")
    ptrs = (pts.data_ptr(), views.data_ptr(), *(t.data_ptr() for t in pack.tensors()),
            gamma.data_ptr(), beta.data_ptr(), rgb.data_ptr(), sdf.data_ptr(), feat.data_ptr())

    def call(fn):
        code = fn(1, *ptrs, BATCH, POINTS, DEPTH, WIDTH, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"launch failed: CUDA error {code}")

    def median_ms(fn, iters=10):
        for _ in range(2):
            call(fn)
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(fn)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    medians = {}
    for rnd in range(2):
        for name, fn in fns.items():
            ms = median_ms(fn)
            medians.setdefault(name, []).append(ms)
            rec = dict(variant=name, round=rnd, ms=ms)
            if name == "as_is":  # the unablated build is the port's kernel
                rec["feat_equal_to_wrapper"] = torch.equal(feat, want)
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
