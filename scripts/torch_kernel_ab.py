#!/usr/bin/env python3
"""Time the port's kernels in two checkouts, in turns, on one GPU.

    python3 scripts/torch_kernel_ab.py OLD NEW [--out results.json]

OLD and NEW are checkouts of the repository, for example a ``git archive``
of an earlier commit unpacked into an ignored directory, and the working
tree.  The script builds both trees' kernels at once (each tree's own
``_ext.build``, one ``nvcc`` per source), then runs OLD, NEW, NEW, OLD, each
in a fresh process started in its tree, with that tree's ``chip_smoke``
timing functions at batch 8:

* ``time_field``: the bf16 and the f32 field kernel, CUDA-event medians of
  10 calls, and their plain versions;
* ``time_ngp_kernels``: ``table_gather`` and ``hash_encode`` (the tuned
  grid's served levels, all its levels, the upstream grid), profiler device
  time per launch on a real request's points;
* ``time_grad_kernels``: the encode's backward (K1) and double backward
  (K2) at the seven shapes of the NGP stage-A G step, profiler device time
  per launch, beside one ``index_add_`` of the same table-gradient pairs;
* one f32 SIREN request (f32 weights, batch 8): its profiled device ms, the
  f32 field kernel's ms in it, and images/s.

One JSON line per run, then one line with every run beside the card's
nvidia-smi name and power limit.  Exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ORDER = ("old", "new", "new", "old")
RUN_TIMEOUT_S = 600


def child_build() -> None:
    import chip_smoke as cs
    from sdface_gan_tpu_torch.ops import _ext

    _ext.build(*cs.SOURCES)


def child_run() -> None:
    import torch

    import chip_smoke as cs
    from sdface_gan_tpu_torch.models import Generator
    from sdface_gan_tpu_torch.ops import siren_kernel as sk
    from sdface_gan_tpu_torch.serving import SDFaceSampler

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    field = cs.time_field({})
    seed = torch.Generator().manual_seed
    tuned = Generator(cs.ngp_configs()["tuned"], device="cuda",
                      generator=seed(0)).to(torch.bfloat16)
    SDFaceSampler(tuned, batch=cs.BATCH)  # packs the tuned grid's tables in place
    ngp = cs.time_ngp_kernels({}, tuned)
    del tuned
    torch.cuda.empty_cache()
    grad = cs.time_grad_kernels({})
    sampler = SDFaceSampler(Generator(cs.full_config(), device="cuda", generator=seed(0)),
                            batch=cs.BATCH)
    sampler.warmup()
    f32 = sk.kernel_name(torch.float32)
    prof = cs.profile_request(sampler, [f32])
    request = dict(kernel=f32, device_ms_total=prof["device_ms_total"],
                   kernel_ms=prof["kernel_ms"][f32], images_per_s=cs.images_per_s(sampler))
    print(json.dumps(dict(field=field, ngp=ngp, grad=grad, f32_request=request)), flush=True)


def spawn(tree: str, mode: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), f"--child-{mode}"],
                            cwd=tree, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main() -> int:
    if "--child-build" in sys.argv or "--child-run" in sys.argv:
        sys.path.insert(0, os.getcwd())
        child_build() if "--child-build" in sys.argv else child_run()
        return 0
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("old", help="checkout timed first and last")
    parser.add_argument("new", help="checkout timed in the middle")
    parser.add_argument("--out", help="also write every run to this JSON file")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    trees = {"old": os.path.abspath(args.old), "new": os.path.abspath(args.new)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    builds = {name: spawn(tree, "build") for name, tree in trees.items()}
    for name, proc in builds.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build of {name} ({trees[name]}) failed:\n{log}")
    runs = []
    for i, name in enumerate(ORDER):
        proc = spawn(trees[name], "run")
        log, _ = proc.communicate(timeout=RUN_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"run {i} of {name} failed:\n{log}")
        rec = dict(run=i, tree=name, **json.loads(log.strip().splitlines()[-1]))
        runs.append(rec)
        print(json.dumps(rec), flush=True)
    result = dict(nvidia_smi=smi, order=list(ORDER), trees=trees, runs=runs)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(dict(nvidia_smi=smi, order=list(ORDER), summary=[
        dict(tree=r["tree"], bf16_ms=r["field"]["bfloat16"]["ms"],
             f32_ms=r["field"]["float32"]["ms"], gather_ms=r["ngp"]["table_gather"]["ms"],
             encode_ms=r["ngp"]["hash_encode"]["ms"],
             encode_upstream_ms=r["ngp"]["hash_encode_upstream"]["ms"],
             f32_request_device_ms=r["f32_request"]["device_ms_total"],
             f32_images_per_s=r["f32_request"]["images_per_s"],
             grad_ms={k: v["ms"] for k, v in r["grad"].items() if isinstance(v, dict)},
             grad_index_add_ms={k: v["library_ms"] for k, v in r["grad"].items()
                                if isinstance(v, dict) and v["library_ms"] is not None})
        for r in runs])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
