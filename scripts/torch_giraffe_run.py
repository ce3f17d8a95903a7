#!/usr/bin/env python3
"""The 64² GIRAFFE recipe of the PyTorch port, as one command.

    python scripts/torch_giraffe_run.py [--out_dir DIR] [--exit-after SECONDS]
        [--seed N] [--device cuda]

It chains the port's command-line entries over
``configs/64res/synthetic_64_giraffe.yaml`` (the one GIRAFFE recipe with a
JAX curve) as ``docs/TRAINING_RUN.md`` chains the JAX ones for its GIRAFFE
run:

1. images: ``python -m sdface_gan_tpu_torch.data.synthetic --png_dir <the
   directory of the yaml's data.path glob>`` (its 4,000 procedural heads;
   kept when the glob matches a file);
2. FID statistics: ``python -m sdface_gan_tpu_torch.calc_fid_stats <that
   directory> --img_size <data.img_size> --out <data.fid_file>`` (kept when
   the file exists);
3. train: ``python -m sdface_gan_tpu_torch.train --config <the yaml> --sdf
   0`` with ``--exit-after`` passed on.  Exit code 3 (the time budget) ends
   this command with 3; run it again to resume from the run's ``model``.
   Each train process's wall seconds are appended to
   ``<out_dir>/train_seconds.jsonl``.

When the run has reached ``training.max_it`` it prints, last, a summary
JSON object: per 2,000-iteration window the medians and ranges of the D
loss (``discriminator``), the G loss (``generator``) and R1
(``regularizer``) beside the JAX run's
(``docs/training_run_giraffe_metrics.jsonl``), each window's breaches of
JAX's range, the FIDs beside JAX's, iterations per second (every iteration
over the train processes' summed wall seconds: start-up, FID, grids and
checkpoints included, the pauses between the calls of a split run not),
beside it the median rate between consecutive logged rows (the training
steps alone), the device's busy and idle share of 5 profiled iterations of
the trained model's D and G steps, and the files the run kept
(``model_best``, ``vis_*.png``).  ``<out_dir>`` receives each command's
log, the metrics file and the summary.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "configs/64res/synthetic_64_giraffe.yaml"
JAX_METRICS = "docs/training_run_giraffe_metrics.jsonl"
WINDOW = 2000
KEYS = ("discriminator", "generator", "regularizer")
PROFILED_ITERS = 5


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="The port's 64^2 GIRAFFE recipe.")
    p.add_argument("--out_dir", default="giraffe_run_report")
    p.add_argument("--exit-after", dest="exit_after", type=int, default=-1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def run(step: str, args: list, out_dir: str, ok=(0,)) -> int:
    """``python -m sdface_gan_tpu_torch.<args[0]> <args[1:]>``, echoed and
    logged to ``<out_dir>/<step>.log``; an exit code outside ``ok`` stops
    the run with it."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", f"sdface_gan_tpu_torch.{args[0]}", *args[1:]]
    print("+", " ".join(cmd), flush=True)
    with open(os.path.join(out_dir, f"{step}.log"), "a") as log:
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        for line in proc.stdout:
            sys.stdout.write(line)
            log.write(line)
        rc = proc.wait()
    if rc not in ok:
        print(f"{step} exited {rc}", flush=True)
        raise SystemExit(rc)
    return rc


def rows(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def windows(metrics: list, max_it: int) -> list:
    """Median, min and max of each loss per window of ``WINDOW`` iterations."""
    out = []
    for lo in range(1, max_it, WINDOW):
        hi = min(lo + WINDOW - 1, max_it)
        sel = [r for r in metrics if lo <= r["step"] <= hi and KEYS[0] in r]
        if sel:
            out.append({"iterations": [lo, hi], **{k: dict(
                median=statistics.median(r[k] for r in sel), min=min(r[k] for r in sel),
                max=max(r[k] for r in sel), n=len(sel)) for k in KEYS}})
    return out


def median_gap_iterations_per_s(metrics: list) -> float:
    """The median rate between consecutive logged loss rows: the training
    steps alone, without the FID, grid and checkpoint pauses (a gap over a
    minute, which holds one of those or the pause between two calls, is
    left out)."""
    steps = [r for r in metrics if KEYS[0] in r]
    rates = [(b["step"] - a["step"]) / (b["time"] - a["time"]) for a, b in zip(steps, steps[1:])
             if b["step"] > a["step"] and 0 < b["time"] - a["time"] < 60]
    return statistics.median(rates) if rates else float("nan")


def busy_share(cfg, args) -> dict:
    """The device's busy share of ``PROFILED_ITERS`` D + G iterations of the
    run's ``model`` at the yaml's batch (the profiler's kernel time over
    the host's wall time of the same iterations)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sdface_gan_tpu_torch.giraffe.train_loop import (
        giraffe_models,
        giraffe_run_configs,
        images_loader,
    )
    from sdface_gan_tpu_torch.giraffe.trainer import (
        giraffe_d_step,
        giraffe_g_step,
        sample_scene_draws,
    )
    from sdface_gan_tpu_torch.utils.checkpoints import CheckpointIO
    from sdface_gan_tpu_torch.utils.device import disable_tf32, resolve_device

    device = resolve_device(args.device)
    disable_tf32()
    configs = giraffe_run_configs(cfg, argparse.Namespace())
    gcfg, hp = configs.generator, configs.hp
    g, d, g_ema, g_opt, d_opt, _, _ = giraffe_models(configs, torch.Generator(), device, False)
    state = CheckpointIO(cfg["training"]["out_dir"]).load("model", map_location=device)
    for m, k in ((g, "g"), (d, "d"), (g_ema, "g_ema"), (g_opt, "g_opt"), (d_opt, "d_opt")):
        m.load_state_dict(state[k])
    loader = iter(images_loader(cfg, hp.batch_size, args.seed))
    gen = torch.Generator().manual_seed(args.seed)

    def iteration():
        x = torch.from_numpy(next(loader)).to(device)
        giraffe_d_step(g, d, d_opt, gcfg, hp, x, sample_scene_draws(gen, gcfg, hp.batch_size,
                                                                     device))
        giraffe_g_step(g, d, g_opt, g_ema, gcfg, hp, sample_scene_draws(gen, gcfg, hp.batch_size,
                                                                         device))

    for _ in range(2):
        iteration()
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_ITERS):
            iteration()
        sync()
        wall = time.perf_counter() - t0
    busy_us = sum(getattr(ev, "device_time_total", 0) for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA)
    busy = busy_us / 1e6 / wall
    return dict(iterations=PROFILED_ITERS, wall_ms_per_iteration=wall / PROFILED_ITERS * 1e3,
                device_busy_ms_per_iteration=busy_us / 1e3 / PROFILED_ITERS, busy_share=busy,
                idle_share=1.0 - busy)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, REPO)
    from sdface_gan_tpu_torch.config import load_config
    from sdface_gan_tpu_torch.config.yaml_config import default_config_path

    cfg = load_config(CONFIG, default_config_path())
    os.makedirs(args.out_dir, exist_ok=True)
    data, tr = cfg["data"], cfg["training"]
    t0 = time.time()
    png_dir = os.path.dirname(data["path"])
    if not glob.glob(data["path"]):
        run("images", ["data.synthetic", "--png_dir", png_dir, "--res", str(data["img_size"]),
                       "--out", png_dir + "_store"], args.out_dir)
    if data.get("fid_file") and not os.path.exists(data["fid_file"]):
        run("fid_stats", ["calc_fid_stats", png_dir, "--img_size", str(data["img_size"]),
                          "--out", data["fid_file"], "--device", args.device], args.out_dir)
    t_train = time.time()
    rc = run("train", ["train", "--config", CONFIG, "--sdf", "0", "--seed", str(args.seed),
                       "--exit-after", str(args.exit_after), "--device", args.device],
             args.out_dir, ok=(0, 3))
    walls_path = os.path.join(args.out_dir, "train_seconds.jsonl")
    with open(walls_path, "a") as f:
        f.write(json.dumps(dict(seconds=time.time() - t_train, rc=rc)) + "\n")
    metrics_path = os.path.join(tr["out_dir"], "giraffe_metrics.jsonl")
    shutil.copy(metrics_path, args.out_dir)
    if rc == 3:
        print("time budget reached: run this command again to resume", flush=True)
        return 3

    ours, theirs = rows(metrics_path), rows(os.path.join(REPO, JAX_METRICS))
    max_it = tr["max_it"]
    wins, jax_wins = windows(ours, max_it), windows(theirs, max_it)
    breaches = [dict(iterations=w["iterations"], key=k, median=w[k]["median"],
                     jax_range=[j[k]["min"], j[k]["max"]])
                for w, j in zip(wins, jax_wins) for k in KEYS
                if not j[k]["min"] <= w[k]["median"] <= j[k]["max"]]
    fid = [(r["step"], r["fid_score"]) for r in ours if "fid_score" in r]
    last_step = max(r["step"] for r in ours)
    train_seconds = sum(r["seconds"] for r in rows(walls_path))
    summary = dict(
        config=CONFIG, max_it=max_it, last_step=last_step,
        windows=wins, jax_windows=jax_wins, breaches=breaches, fid=fid,
        jax_fid=[(r["step"], r["fid_score"]) for r in theirs if "fid_score" in r],
        fid_falls=len(fid) >= 2 and fid[-1][1] < fid[0][1],
        all_finite=all(v == v and abs(v) != float("inf") for r in ours for k, v in r.items()
                       if k in KEYS),
        train_seconds=train_seconds, iterations_per_s=max_it / train_seconds,
        median_gap_iterations_per_s=median_gap_iterations_per_s(ours),
        profile=busy_share(cfg, args),
        model_best=os.path.exists(os.path.join(tr["out_dir"], "model_best.pt")),
        vis=sorted(os.path.basename(p) for p in glob.glob(os.path.join(tr["out_dir"],
                                                                       "vis_*.png"))),
        seconds=time.time() - t0)
    for p in glob.glob(os.path.join(tr["out_dir"], "vis_*.png")):
        shutil.copy(p, args.out_dir)
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
