#!/usr/bin/env python3
"""The staged 64² convergence run of the PyTorch port, as one command.

    python scripts/torch_convergence_run.py [--out_dir DIR] [--device cuda]

It chains the port's command-line entries as ``docs/TRAINING_RUN.md``
chains the JAX ones for its subsampled-eikonal arm
(``configs/64res/synthetic_64_sdf_solid_eik.yaml``):

1. store: ``python -m sdface_gan_tpu_torch.data.synthetic --res 64 --flat_bg 0.5
   --out <the config's data.path>`` (kept when it already exists);
2. train: ``python -m sdface_gan_tpu_torch.train --config <config> --sdf 1
   --batch 8 --iters 5001 --sphere_init_iters 10000``: sphere init, stage A,
   stage B;
3. judge: ``probe_geometry --stage a``, ``probe_geometry --stage b --mesh``,
   ``sdf_mesh --identities 1``, and ``eval --real_dir <store> --no_dump`` at
   the 5,000-image protocol.

Each command's output is echoed and kept in ``<out_dir>/<step>.log``; the
two metrics files are copied into ``out_dir``.  The last line printed is a
summary JSON object: the probe lines and verdicts, the mesh counts, FID
and KID, the losses at the yardstick steps beside the JAX run's
(``docs/training_run_solid_eik*_metrics.jsonl``), seconds per 100 steps
of each phase, and each command's wall seconds.  A command that fails
stops the run with its exit code.  Every count is a flag, so a short run
(a smoke test, a CPU test at a tiny config) takes the same path.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YARDSTICK_STEPS = (0, 1000, 2500, 5000)
STAGE_A_KEYS = ("d", "fg_mass", "g_eikonal", "beta")
STAGE_B_KEYS = ("d", "g", "g_content", "path_length")
JAX_METRICS = {"stage_a": "docs/training_run_solid_eik_metrics.jsonl",
               "stage_b": "docs/training_run_solid_eik_stageB_metrics.jsonl"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="The port's staged 64^2 convergence run.")
    p.add_argument("--config", default="configs/64res/synthetic_64_sdf_solid_eik.yaml")
    p.add_argument("--store_images", type=int, default=4000,
                   help="images rendered into the store when it does not exist")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=5001, help="iterations of stage A and of B")
    p.add_argument("--sphere_init_iters", type=int, default=10000)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--probe_identities", type=int, default=4)
    p.add_argument("--probe_res", type=int, default=64)
    p.add_argument("--surface_res", type=int, default=128)
    p.add_argument("--eval_images", type=int, default=5000)
    p.add_argument("--out_dir", default=None,
                   help="logs, metrics copies and summary (default out/<exp>/convergence)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def run(name: str, module: str, args: list, out_dir: str) -> dict:
    """``python -m sdface_gan_tpu_torch.<module> <args>`` with this checkout
    on the path; its output echoed and written to ``<out_dir>/<name>.log``.
    Exits with the command's code if it fails."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", f"sdface_gan_tpu_torch.{module}", *args]
    print(f"$ {' '.join(cmd[1:])}", flush=True)
    lines = []
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, f"{name}.log"), "w") as log, \
            subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, bufsize=1) as proc:
        for line in proc.stdout:
            sys.stdout.write(line)
            log.write(line)
            lines.append(line.rstrip("\n"))
        rc = proc.wait()
    seconds = time.perf_counter() - t0
    if rc != 0:
        print(f"{name}: {module} exited {rc}", file=sys.stderr, flush=True)
        raise SystemExit(rc)
    return dict(seconds=seconds, lines=lines)


def read_rows(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def seconds_per_100(rows: list) -> float | None:
    """Median host seconds per 100 steps between consecutive logged rows."""
    rates = [(b["time"] - a["time"]) / (b["step"] - a["step"]) * 100
             for a, b in zip(rows, rows[1:]) if b["step"] > a["step"]]
    return statistics.median(rates) if rates else None


def at_steps(rows: list, keys: tuple) -> dict:
    by_step = {r["step"]: r for r in rows}
    return {str(s): {k: by_step[s][k] for k in keys if k in by_step[s]}
            for s in YARDSTICK_STEPS if s in by_step}


def curve_summary(rows: list, keys: tuple) -> dict:
    """The yardstick steps' losses, whether every logged value is finite,
    and the logged range of each key."""
    values = [v for r in rows for k, v in r.items() if k not in ("step", "time")]
    return dict(at=at_steps(rows, keys), logged=len(rows),
                last_step=rows[-1]["step"] if rows else None,
                all_finite=all(math.isfinite(v) for v in values),
                ranges={k: [min(r[k] for r in rows if k in r), max(r[k] for r in rows if k in r)]
                        for k in keys if any(k in r for r in rows)},
                seconds_per_100=seconds_per_100(rows))


def probe_summary(lines: list) -> dict:
    ids = [ln for ln in lines if ln.startswith("id")]
    crossing = [float(ln.split("ray-crossing ")[1].split()[0]) for ln in ids
                if "ray-crossing " in ln]
    verdict = [ln.split("verdict: ", 1)[1] for ln in lines if ln.startswith("verdict: ")]
    return dict(lines=ids, verdict=verdict[-1] if verdict else None,
                crossing=[min(crossing), max(crossing)] if crossing else None)


def main(argv=None) -> dict:
    args = parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    from sdface_gan_tpu_torch.bench import card
    from sdface_gan_tpu_torch.config import load_config
    from sdface_gan_tpu_torch.config.yaml_config import default_config_path

    cfg = load_config(args.config, default_config_path())
    exp = cfg["training"]["out_dir"].split("/")[1]
    out_base = os.path.join("out", exp)
    store = cfg["data"]["path"]
    res = int(cfg["data"]["img_size"])
    out_dir = args.out_dir or os.path.join(out_base, "convergence")
    os.makedirs(out_dir, exist_ok=True)
    device = ["--device", args.device]
    commands = {}

    if not os.path.exists(os.path.join(store, "index.bin")):
        commands["store"] = run("store", "data.synthetic", [
            "--res", str(res), "--flat_bg", "0.5", "--n", str(args.store_images),
            "--out", store], out_dir)
    commands["train"] = run("train", "train", [
        "--config", args.config, "--sdf", "1", "--batch", str(args.batch),
        "--iters", str(args.iters), "--sphere_init_iters", str(args.sphere_init_iters),
        "--log_every", str(args.log_every), *device], out_dir)
    probe = ["--config", args.config, "--identities", str(args.probe_identities),
             "--res", str(args.probe_res), *device]
    commands["probe_a"] = run("probe_a", "probe_geometry", [*probe, "--stage", "a"], out_dir)
    commands["probe_b"] = run("probe_b", "probe_geometry", [*probe, "--stage", "b", "--mesh"],
                              out_dir)
    commands["sdf_mesh"] = run("sdf_mesh", "sdf_mesh", [
        "--config", args.config, "--identities", "1", "--surface_res", str(args.surface_res),
        *device], out_dir)
    commands["eval"] = run("eval", "eval", [
        "--config", args.config, "--n_images", str(args.eval_images), "--batch", str(args.batch),
        "--real_dir", store, "--no_dump", *device], out_dir)

    metrics = {"stage_a": os.path.join(out_base, "volume_renderer", "vol_render_metrics.jsonl"),
               "stage_b": os.path.join(out_base, "full_pipeline_metrics.jsonl")}
    for path in metrics.values():
        shutil.copy(path, out_dir)
    rows_a = read_rows(metrics["stage_a"])
    sphere = [r for r in rows_a if "sdf_init_loss" in r]
    stage_a = [r for r in rows_a if "d" in r]
    stage_b = read_rows(metrics["stage_b"])
    jax = {k: read_rows(os.path.join(REPO, p)) for k, p in JAX_METRICS.items()}

    fid = [ln for ln in commands["eval"]["lines"] if ln.startswith("FID:")]
    meshes = [ln for ln in commands["sdf_mesh"]["lines"] if ln.startswith("id") and "verts" in ln]
    summary = dict(
        config=args.config, device=args.device, nvidia_smi=card(torch.device(args.device)), batch=args.batch, iters=args.iters,
        sphere_init_iters=args.sphere_init_iters, eval_images=args.eval_images,
        sphere_init=dict(logged=len(sphere), first=sphere[0]["sdf_init_loss"] if sphere else None,
                         last=sphere[-1]["sdf_init_loss"] if sphere else None,
                         seconds_per_100=seconds_per_100(sphere)),
        stage_a=curve_summary(stage_a, STAGE_A_KEYS),
        stage_b=curve_summary(stage_b, STAGE_B_KEYS),
        jax=dict(stage_a=at_steps([r for r in jax["stage_a"] if "d" in r], STAGE_A_KEYS),
                 stage_b=at_steps(jax["stage_b"], STAGE_B_KEYS)),
        probe_a=probe_summary(commands["probe_a"]["lines"]),
        probe_b=probe_summary(commands["probe_b"]["lines"]),
        mesh=meshes, fid=fid[-1] if fid else None,
        seconds={name: c["seconds"] for name, c in commands.items()})
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
