#!/usr/bin/env python3
"""Where the encode's backward and double backward kernels' time goes, by variant, on one GPU.

    python3 scripts/torch_hash_grad_ablations.py [--out results.json]

Builds ``sdface_gan_tpu_torch/ops/csrc/hash_grid.cu`` as it is and in
variants of its K1 (``hash_encode_backward_kernel``) and K2
(``hash_encode_double_backward_kernel``), each computing the same function
another way:

* ``agg_none`` - no level sums a cell's lanes in the warp first;
* ``agg_16``, ``agg_40``, ``agg_70``, ``agg_128``, ``agg_all`` - the levels
  of scale up to 16, 40, 70, 128, or every level, do (the source: up to 64,
  the tuned grid's levels 0-1 and the upstream grid's 0-3);
* ``scalar`` - a corner row goes out as C scalar atomics, not as vector
  reductions;
* ``unpaired`` - d x and d g read each corner row alone, not an
  x-neighbour pair in one load;
* ``no_pair_add`` - at C <= 2 each corner row is its own reduction, also
  where the x-neighbours' rows form an aligned pair;
* ``joint`` - a launch asked for both outputs gives each thread both,
  instead of a half of the blocks to each;
* ``scatter_first`` - a level's table gradient goes out before its reads
  for d x or d g, not after.

Each variant is compiled with one ``nvcc`` (all started together) into
``.torch_ext_build/ablations/``, loaded in place of the port's
``hash_grid`` library, and driven through the port's wrappers at the seven
shapes of the NGP stage-A G step (``chip_smoke.GRAD_CASES``: batch 8, a
real request's points, random tables from a seed): the profiler's device
ms per launch, the variants in turns, two rounds.  Each variant's outputs
are held against the source's where K1 and K2 write both their outputs.
Then, per level, K1's table gradient at the render's shapes of both grids,
for the source and ``agg_none``: where the levels' time goes.  One JSON
line per timing, then one with every time and the card's nvidia-smi name
and power limit.  Exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(HERE, "sdface_gan_tpu_torch", "ops", "csrc", "hash_grid.cu")
BUILD = os.path.join(HERE, ".torch_ext_build", "ablations")

THRESHOLD = "constexpr float kAggregateMaxScale = 64.0f;"
VECTOR4 = "  if constexpr (C % 4 == 0) {"
VECTOR2 = "  } else if constexpr (C == 2) {"
PAIR_K1 = "load_corner_pair<T, C>(table, cr.row[k], cr.row[k + 1], v[0], v[1]);"
PAIR_K2 = "load_corner_pair<T, C>(table, cr.row[k], cr.row[k + 1], tv[0], tv[1]);"
PAIR_ADD = "  if constexpr (C <= 2) {\n    if (r1 == (r0 ^ 1u)) {"
SPLIT_K1 = "  if (dx && dtable) {  // the first half of the blocks d x, the second d table"
SPLIT_K2 = "  if (dtable && dg) {  // the first half of the blocks d g, the second d table"
SPLIT_GRID = ("  if (second ? a.dtable && a.dg : a.dx && a.dtable) blocks *= 2;"
              "  // each output its half\n")
SCATTER_K1 = "    if (dtable) scatter_level<C>(dtable, lv.aggregate, active, cr, cr.w, gl);\n"
READS_K1 = "    if (dx) {\n      float gf[3]"
SCATTER_K2 = ("    if (dtable) {\n      float gl[C];\n"
              "      load_row<T, C>(g, (size_t)p * n_levels + l, gl);\n"
              "      scatter_level<C>(dtable, lv.aggregate, active, cr, q, gl);\n    }\n")
READS_K2 = "    if (dg) {\n      float acc[C] = {};"


def _threshold(value: str) -> tuple:
    return ((THRESHOLD, f"constexpr float kAggregateMaxScale = {value};"),)


def _unpaired(rows: str) -> tuple:
    pair = PAIR_K1 if rows == "v" else PAIR_K2
    return (pair, f"load_row<T, C>(table, cr.row[k], {rows}[0]);\n"
                  f"        load_row<T, C>(table, cr.row[k + 1], {rows}[1]);")


VARIANTS = {  # name: text edits
    "as_is": (),
    "agg_none": _threshold("-1.0f"),
    "agg_16": _threshold("16.0f"),
    "agg_40": _threshold("40.0f"),
    "agg_70": _threshold("70.0f"),
    "agg_128": _threshold("128.0f"),
    "agg_all": _threshold("3.0e38f"),
    "scalar": ((VECTOR4, "  if constexpr (false) {"),
               (VECTOR2, "  } else if constexpr (false) {")),
    "unpaired": (_unpaired("v"), _unpaired("tv")),
    "no_pair_add": ((PAIR_ADD, PAIR_ADD.replace("C <= 2", "false")),),
    "joint": ((SPLIT_K1, "  if (false) {"), (SPLIT_K2, "  if (false) {"), (SPLIT_GRID, "")),
    "scatter_first": ((SCATTER_K1, ""), (READS_K1, SCATTER_K1 + READS_K1),
                      (SCATTER_K2, ""), (READS_K2, SCATTER_K2 + READS_K2)),
}
KERNELS = {"backward": "hash_encode_backward_kernel",
           "double": "hash_encode_double_backward_kernel"}
PER_LEVEL = ("as_is", "agg_none")
PER_LEVEL_CASES = ("t_render_k1", "u_render_k1")


def build(nvcc_flags, nvcc) -> dict:
    """Write and compile every variant, all nvcc processes at once."""
    src = open(SOURCE).read()
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:  # str.replace would edit every copy
                raise RuntimeError(f"variant {name}: the source holds {old!r} "
                                   f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        cu = os.path.join(BUILD, f"hash_grid_{name}.cu")
        so = os.path.join(BUILD, f"hash_grid_{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = (so, subprocess.Popen([nvcc, *nvcc_flags, "-o", so, cu], text=True,
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        ptxas, entry = [], ""
        for ln in log.splitlines():  # K1's and K2's registers and spills
            if "Compiling entry function" in ln:
                entry = ln
            elif ("registers" in ln or "spill" in ln) and "backward" in entry:
                ptxas.append(ln.strip())
        print(json.dumps(dict(variant=name, ptxas=ptxas)), flush=True)
        lib = ctypes.CDLL(so)
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write every time to this JSON file")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from sdface_gan_tpu_torch.ops import _ext
    from sdface_gan_tpu_torch.ops import hash_encoder as hg

    torch.set_grad_enabled(False)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    libs = build(_ext.NVCC_FLAGS, _ext._nvcc())

    grids, points = cs.grad_grids(), cs.grad_case_points()
    cases = {}
    for name, (grid, dtype, pts, kernel, need_x, need_table, need_g) in cs.GRAD_CASES.items():
        spec, x = grids[grid], points[pts]
        n, c = x.shape[0], spec.level_dim
        gen = torch.Generator(device="cuda").manual_seed(41)
        table = torch.randn((spec.table_size, c), generator=gen,
                            device="cuda").to(getattr(torch, dtype))
        g = torch.randn((n, spec.output_dim), generator=gen, device="cuda").to(table.dtype)
        v = torch.randn((n, 3), generator=gen, device="cuda")
        if kernel == "backward":
            def fn(x=x, table=table, g=g, spec=spec, need_x=need_x, need_table=need_table):
                return hg.hash_encode_backward(x, table, g, spec, cs.NGP_BOUND, need_x=need_x,
                                               need_table=need_table)
        else:
            def fn(x=x, table=table, g=g, v=v, spec=spec, need_table=need_table, need_g=need_g):
                return hg.hash_encode_double_backward(x, table, g, v, spec, cs.NGP_BOUND,
                                                      need_table=need_table, need_g=need_g)
        cases[name] = dict(fn=fn, kernel=KERNELS[kernel], spec=spec, x=x, table=table, g=g)

    def use(variant):
        _ext._LIBS["hash_grid"] = libs[variant]

    held = ("u_k1_both", "u_eikonal_k2")  # both outputs of K1 and of K2, f32
    use("as_is")
    want = {case: cases[case]["fn"]() for case in held}
    ms = {}
    for rnd in range(2):
        for variant in VARIANTS:
            use(variant)
            for case in held if rnd == 0 else ():
                got = cases[case]["fn"]()
                torch.cuda.synchronize()
                errs = [cs._rel_err(a, b) for a, b in zip(got, want[case])]
                cs.check(max(errs) <= cs.GRAD_RTOL["float32"],
                         f"variant {variant}, {case}: outputs against the source's {errs}")
            for case, rec in cases.items():
                t = cs.device_ms(rec["fn"], rec["kernel"])
                ms.setdefault(variant, {}).setdefault(case, []).append(t)
                print(json.dumps(dict(variant=variant, round=rnd, case=case, ms=t)), flush=True)
    per_level = {}
    for variant in PER_LEVEL:
        use(variant)
        for case in PER_LEVEL_CASES:
            rec = cases[case]
            spec, x = rec["spec"], rec["x"]
            g = rec["g"].reshape(x.shape[0], spec.num_levels, spec.level_dim)
            for lvl in range(spec.num_levels):
                gl = g[:, lvl].contiguous()
                t = cs.device_ms(lambda: hg.hash_encode_backward(
                    x, rec["table"], gl, spec, cs.NGP_BOUND, levels=(lvl,), need_x=False),
                    "hash_encode_backward_kernel")
                per_level.setdefault(variant, {}).setdefault(case, []).append(t)
                print(json.dumps(dict(variant=variant, case=case, level=lvl,
                                      scale=spec.level_scale(lvl), ms=t)), flush=True)
    use("as_is")
    result = dict(nvidia_smi=smi, ms=ms, per_level_ms=per_level)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
