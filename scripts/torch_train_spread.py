#!/usr/bin/env python3
"""The card's run-to-run spread of a training command, row by row.

    python3 scripts/torch_train_spread.py [--reruns 3]

Builds ``chip_smoke.py``'s train_cli store (16 procedural 320 x 288 PNGs and
the committed image fixtures, ``prepare_data --size 256``) in a temporary
directory of the checkout, runs train_cli's entry (``python -m
sdface_gan_tpu_torch.train --config configs/256res/ffhq_256_sdf_tpu.yaml
--sdf 1 --iters 3 ...``) alone, then at once ``--reruns`` plain reruns of
it and the same command under ``python -m torch.distributed.run
--standalone --nproc_per_node 1`` (an NCCL group at world 1), each its own
experiment.  Prints one JSON line per run and logged row: every logged
loss's relative difference from the entry's (sphere init, stage A, stage
B).  These readings set the bars of ``chip_smoke.py``'s ``ddp_nccl`` check.
Exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reruns", type=int, default=3)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_train_spread: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import chip_smoke as cs
    from sdface_gan_tpu_torch import native
    from sdface_gan_tpu_torch.data.png import encode_png

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    native.build()
    td = tempfile.mkdtemp(dir=HERE, prefix=".chip_smoke_train_spread_")
    try:
        os.makedirs(os.path.join(td, "imgs"))
        os.symlink(os.path.join(HERE, "configs"), os.path.join(td, "configs"))
        for i, img in enumerate(cs.procedural_images(cs.CLI_IMAGES, cs.CLI_HW, seed=11)):
            with open(os.path.join(td, "imgs", f"{i:05d}.png"), "wb") as f:
                f.write(encode_png(img))
        for name in cs.train_cli_fixtures():
            shutil.copy(os.path.join(cs.IMAGE_FIXTURES, name), os.path.join(td, "imgs", name))
        cs.run_module("prepare_data", ["imgs", "--out", "store", "--size", str(cs.CLI_SIZE),
                                       "--n_worker", "8"], td)
        flags = ["--sdf", "1", "--dataset_path", "store", "--iters", "3", *cs.CLI_TRAIN_FLAGS]
        cs.run_module("train", ["--config", cs.CLI_CONFIG, *flags], td)
        runs = [f"rerun{i}" for i in range(args.reruns)] + ["nccl"]
        for exp in runs:
            with open(os.path.join(td, f"{exp}.yaml"), "w") as f:
                f.write(f"inherit_from: {cs.CLI_CONFIG}\ntraining:\n  out_dir: out/{exp}\n")
        jobs = {exp: [("train", ["--config", f"{exp}.yaml", *flags])] for exp in runs[:-1]}
        jobs["nccl"] = [("torch.distributed.run", [
            "--standalone", "--nproc_per_node", "1", "-m", "sdface_gan_tpu_torch.train",
            "--config", "nccl.yaml", *flags])]
        cs.run_modules_together(jobs, td)

        def rows(exp):
            out = os.path.join(td, "out", exp)
            return (cs._train_rows(os.path.join(out, "volume_renderer", "vol_render_metrics.jsonl")),
                    cs._train_rows(os.path.join(out, "full_pipeline_metrics.jsonl")))

        ref = rows(cs.CLI_EXP)
        for exp in runs:
            for stage, (got, want) in zip("AB", zip(rows(exp), ref)):
                for g, w in zip(got, want):
                    errs = {k: abs(g[k] - v) / max(abs(v), 1e-12) for k, v in w.items()
                            if k not in ("step", "time") and not k.endswith("_ms")}
                    print(json.dumps(dict(run=exp, stage=stage, step=w["step"],
                                          adversarial="g" in w, rel_err=errs)), flush=True)
    finally:
        shutil.rmtree(td, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
