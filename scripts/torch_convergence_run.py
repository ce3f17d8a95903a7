#!/usr/bin/env python3
"""The staged 64² convergence run of the PyTorch port, as one command.

    python scripts/torch_convergence_run.py [--config YAML] [--seed N]
        [--save_every N] [--stop_after_a] [--stage_c vae,psp] [--out_dir DIR]
        [--device cuda]

It chains the port's command-line entries as ``docs/TRAINING_RUN.md``
chains the JAX ones for its subsampled-eikonal arm
(``configs/64res/synthetic_64_sdf_solid_eik.yaml``):

1. store: ``python -m sdface_gan_tpu_torch.data.synthetic --res 64 --flat_bg 0.5
   --out <the config's data.path>`` (kept when it already exists);
2. train: ``python -m sdface_gan_tpu_torch.train --config <config> --sdf 1
   --batch 8 --iters 5001 --sphere_init_iters 10000 --seed <seed>
   --save_every <save_every>``: sphere init, stage A, stage B (each skipped
   when its artifact exists, so a run split across machines resumes at the
   stage artifacts);
3. judge: ``probe_geometry --stage a``, ``probe_geometry --stage b --mesh``,
   ``sdf_mesh --identities 1``, ``eval --real_dir <store> --no_dump`` at
   the 5,000-image protocol, ``probe_geometry --stage a --ckpt
   models_<step>`` on every stage-A checkpoint not probed before, and the
   stage-C legs of ``--stage_c`` (``train --vae 1`` / ``--psp 1``, 4,001
   iterations at the batch, no perceptual weights, against the run's own
   stage-B generator), run together (each reads the trained artifacts and
   writes its own outputs).

The JAX yardstick is the JAX run of the config, or of the nearest yaml it
inherits from (``JAX_SERIES``); a config with none is refused before
anything runs.  Each command's output is echoed and kept in
``<out_dir>/<step>.log``; the metrics files are copied into ``out_dir``,
and each checkpoint probe is kept as a line of
``<out_dir>/checkpoint_probes.jsonl`` (so a split run probes each
checkpoint once, on the machine that wrote it).  ``--stop_after_a`` ends
the train command where stage B would begin and runs stage A's judges
only: the first half of a run split across machines, carried on by a run
without it from the stage-A artifact.  The last line printed is
a summary JSON object: the probe lines and verdicts, the verdict,
crossing, sdf range and beta of each probed checkpoint, the mesh counts,
FID and KID, the losses at the yardstick steps beside the JAX run's, beta
there beside every JAX run of the recipe, the stage-C curves beside
``docs/training_run_stageC_{vae,psp}_metrics.jsonl``, seconds per 100
steps of each phase, and each command's wall seconds.  A command that
fails stops the run with its exit code.  Every count is a flag, so a
short run (a smoke test, a CPU test at a tiny config) takes the same
path.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YARDSTICK_STEPS = (0, 1000, 2500, 5000)
STAGE_C_STEPS = (0, 1000, 2000, 3000, 4000)
STAGE_A_KEYS = ("d", "fg_mass", "g_eikonal", "beta")
STAGE_B_KEYS = ("d", "g", "g_content", "path_length")
STAGE_C_KEYS = ("e_kl", "e_l2_full", "e_l2_thumb", "e_loss")
# the train entry's first line of stage B, fresh or resumed
STAGE_B_START = ("initialized renderer from", "resumed full pipeline at step")
# the JAX runs of the recipe, by the yaml that ran them (docs/TRAINING_RUN.md:
# seed 0 on the first, --seed 1 on the second): (stage A, stage B) series
JAX_SERIES = {
    "synthetic_64_sdf_solid_eik.yaml": ("docs/training_run_solid_eik_metrics.jsonl",
                                        "docs/training_run_solid_eik_stageB_metrics.jsonl"),
    "synthetic_64_sdf_solid_eik_s1.yaml": ("docs/training_run_solid_eik_s1_metrics.jsonl",
                                           "docs/training_run_solid_eik_s1_stageB_metrics.jsonl")}
JAX_STAGE_C = {"vae": "docs/training_run_stageC_vae_metrics.jsonl",
               "psp": "docs/training_run_stageC_psp_metrics.jsonl"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="The port's staged 64^2 convergence run.")
    p.add_argument("--config", default="configs/64res/synthetic_64_sdf_solid_eik.yaml")
    p.add_argument("--store_images", type=int, default=4000,
                   help="images rendered into the store when it does not exist")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=5001, help="iterations of stage A and of B")
    p.add_argument("--sphere_init_iters", type=int, default=10000)
    p.add_argument("--log_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_every", type=int, default=10000,
                   help="stage checkpoints every N steps; each stage-A one is probed")
    p.add_argument("--stage_c", default="",
                   help="comma-separated stage-C legs to train after stage B: vae, psp")
    p.add_argument("--stage_c_iters", type=int, default=4001)
    p.add_argument("--stage_c_log_every", type=int, default=50)
    p.add_argument("--stop_after_a", action="store_true",
                   help="stop once stage A is trained and judged (a run split across "
                        "machines; a later run resumes at stage B from vol_renderer)")
    p.add_argument("--probe_identities", type=int, default=4)
    p.add_argument("--probe_res", type=int, default=64)
    p.add_argument("--surface_res", type=int, default=128)
    p.add_argument("--eval_images", type=int, default=5000)
    p.add_argument("--out_dir", default=None,
                   help="logs, metrics copies and summary (default out/<exp>/convergence)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def run(name: str, module: str, args: list, out_dir: str, stop_at: tuple = ()) -> dict:
    """``python -m sdface_gan_tpu_torch.<module> <args>`` with this checkout
    on the path; its output echoed and written to ``<out_dir>/<name>.log``.
    Exits with the command's code if it fails; a line that starts with one
    of ``stop_at`` ends the command there (terminated, not failed)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", f"sdface_gan_tpu_torch.{module}", *args]
    print(f"$ {' '.join(cmd[1:])}", flush=True)
    lines = []
    t0 = time.perf_counter()
    with open(os.path.join(out_dir, f"{name}.log"), "w") as log, \
            subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, bufsize=1) as proc:
        stopped = False
        for line in proc.stdout:
            sys.stdout.write(line)
            log.write(line)
            lines.append(line.rstrip("\n"))
            if stop_at and not stopped and line.startswith(stop_at):
                proc.terminate()
                stopped = True
        rc = proc.wait()
    seconds = time.perf_counter() - t0
    if rc != 0 and not stopped:
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
    sdf = [[float(v) for v in m.groups()] for m in
           (re.search(r"sdf\[([-+.\d]+),([-+.\d]+)\]", ln) for ln in ids) if m]
    verdict = [ln.split("verdict: ", 1)[1] for ln in lines if ln.startswith("verdict: ")]
    beta = [float(ln.split()[1]) for ln in lines if ln.startswith("beta ")]
    return dict(lines=ids, verdict=verdict[-1] if verdict else None,
                crossing=[min(crossing), max(crossing)] if crossing else None,
                sdf=[min(lo for lo, _ in sdf), max(hi for _, hi in sdf)] if sdf else None,
                beta=beta[-1] if beta else None)


def yardstick(config: str) -> str:
    """The name in ``JAX_SERIES`` of ``config`` or of the nearest yaml it
    inherits from; exits naming ``config`` when there is none."""
    from sdface_gan_tpu_torch.config.yaml_config import parent_path

    path = config
    while path is not None:
        if os.path.basename(path) in JAX_SERIES:
            return os.path.basename(path)
        path = parent_path(path)
    raise SystemExit(f"{config}: no JAX run of this config or of a yaml it inherits from "
                     f"(known: {', '.join(JAX_SERIES)})")


def checkpoint_steps(vr_dir: str) -> list:
    return sorted(int(m.group(1)) for m in (
        re.fullmatch(r"models_(\d{7})\.pt", os.path.basename(p))
        for p in glob.glob(os.path.join(vr_dir, "models_*.pt"))) if m)


def stage_c_summary(rows: list, jax_rows: list, key: str) -> dict:
    """The stage-C curve at ``STAGE_C_STEPS`` beside JAX's, whether every
    logged value is finite, and ``key``'s first / last ratio (its fall)."""
    def at(rs):
        by_step = {r["step"]: r for r in rs}
        return {str(s): {k: by_step[s][k] for k in STAGE_C_KEYS if k in by_step[s]}
                for s in STAGE_C_STEPS if s in by_step}

    values = [v for r in rows for k, v in r.items() if k not in ("step", "time")]
    fall = (rows[0][key] / rows[-1][key]) if rows and rows[-1][key] else None
    jax_fall = jax_rows[0][key] / jax_rows[-1][key]
    return dict(at=at(rows), jax=at(jax_rows), logged=len(rows),
                last_step=rows[-1]["step"] if rows else None,
                all_finite=bool(rows) and all(math.isfinite(v) for v in values),
                fall_key=key, fall=fall, jax_fall=jax_fall,
                seconds_per_100=seconds_per_100(rows))


def main(argv=None) -> dict:
    args = parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    from sdface_gan_tpu_torch.bench import card
    from sdface_gan_tpu_torch.config import load_config
    from sdface_gan_tpu_torch.config.yaml_config import default_config_path

    legs = [leg for leg in args.stage_c.split(",") if leg]
    if set(legs) - set(JAX_STAGE_C):
        raise SystemExit(f"--stage_c {args.stage_c}: legs are {', '.join(JAX_STAGE_C)}")
    yard = yardstick(args.config)
    cfg = load_config(args.config, default_config_path())
    exp = cfg["training"]["out_dir"].split("/")[1]
    out_base = os.path.join("out", exp)
    vr_dir = os.path.join(out_base, "volume_renderer")
    store = cfg["data"]["path"]
    res = int(cfg["data"]["img_size"])
    out_dir = args.out_dir or os.path.join(out_base, "convergence")
    os.makedirs(out_dir, exist_ok=True)
    device = ["--device", args.device]
    common = ["--config", args.config, "--sdf", "1", "--batch", str(args.batch),
              "--seed", str(args.seed), "--save_every", str(args.save_every), *device]
    commands = {}

    if not os.path.exists(os.path.join(store, "index.bin")):
        commands["store"] = run("store", "data.synthetic", [
            "--res", str(res), "--flat_bg", "0.5", "--n", str(args.store_images),
            "--out", store], out_dir)
    commands["train"] = run("train", "train", [
        *common, "--iters", str(args.iters), "--sphere_init_iters", str(args.sphere_init_iters),
        "--log_every", str(args.log_every)], out_dir,
        stop_at=STAGE_B_START if args.stop_after_a else ())
    probe = ["--config", args.config, "--identities", str(args.probe_identities),
             "--res", str(args.probe_res), *device]
    probes_path = os.path.join(out_dir, "checkpoint_probes.jsonl")
    probed = {r["step"] for r in read_rows(probes_path)} if os.path.exists(probes_path) else set()
    new_steps = [s for s in checkpoint_steps(vr_dir) if s not in probed]
    judges = {
        "probe_a": ("probe_geometry", [*probe, "--stage", "a"]),
        **{f"probe_a_{s:07d}": ("probe_geometry", [*probe, "--stage", "a", "--ckpt",
                                                   f"models_{s:07d}"]) for s in new_steps}}
    if not args.stop_after_a:
        judges.update({
            "probe_b": ("probe_geometry", [*probe, "--stage", "b", "--mesh"]),
            "sdf_mesh": ("sdf_mesh", ["--config", args.config, "--identities", "1",
                                      "--surface_res", str(args.surface_res), *device]),
            "eval": ("eval", ["--config", args.config, "--n_images", str(args.eval_images),
                              "--batch", str(args.batch), "--real_dir", store, "--no_dump",
                              *device]),
            **{f"stage_c_{leg}": ("train", [*common, f"--{leg}", "1",
                                            "--iters", str(args.stage_c_iters),
                                            "--log_every", str(args.stage_c_log_every)])
               for leg in legs}})
    with ThreadPoolExecutor(len(judges)) as pool:
        futures = {name: pool.submit(run, name, module, judge_args, out_dir)
                   for name, (module, judge_args) in judges.items()}
        commands.update({name: future.result() for name, future in futures.items()})
    with open(probes_path, "a") as f:
        for s in new_steps:
            f.write(json.dumps(dict(step=s, **probe_summary(
                commands[f"probe_a_{s:07d}"]["lines"]))) + "\n")

    metrics = {"stage_a": os.path.join(vr_dir, "vol_render_metrics.jsonl"),
               "stage_b": os.path.join(out_base, "full_pipeline_metrics.jsonl")}
    if args.stop_after_a:
        del metrics["stage_b"]
    for path in metrics.values():
        shutil.copy(path, out_dir)
    stage_c = {}
    for leg in legs:
        path = os.path.join(out_base, "encoder_psp" if leg == "psp" else "encoder",
                            "encoder_metrics.jsonl")
        shutil.copy(path, os.path.join(out_dir, f"stageC_{leg}_metrics.jsonl"))
        stage_c[leg] = stage_c_summary(read_rows(path), read_rows(os.path.join(
            REPO, JAX_STAGE_C[leg])), "e_kl" if leg == "vae" else "e_l2_full")
    rows_a = read_rows(metrics["stage_a"])
    sphere = [r for r in rows_a if "sdf_init_loss" in r]
    stage_a = [r for r in rows_a if "d" in r]
    stage_b = read_rows(metrics["stage_b"]) if "stage_b" in metrics else None
    jax = {name: [read_rows(os.path.join(REPO, p)) for p in paths]
           for name, paths in JAX_SERIES.items()}
    beta = {str(s): {"port": v["beta"]} for s, v in at_steps(stage_a, ("beta",)).items()}
    for name, (rows_jax, _) in jax.items():
        for s, v in at_steps([r for r in rows_jax if "d" in r], ("beta",)).items():
            beta.setdefault(s, {})[name] = v["beta"]

    def lines(name):
        return commands[name]["lines"] if name in commands else []

    fid = [ln for ln in lines("eval") if ln.startswith("FID:")]
    meshes = [ln for ln in lines("sdf_mesh") if ln.startswith("id") and "verts" in ln]
    summary = dict(
        config=args.config, seed=args.seed, device=args.device,
        nvidia_smi=card(torch.device(args.device)), batch=args.batch, iters=args.iters,
        sphere_init_iters=args.sphere_init_iters, eval_images=args.eval_images,
        sphere_init=dict(logged=len(sphere), first=sphere[0]["sdf_init_loss"] if sphere else None,
                         last=sphere[-1]["sdf_init_loss"] if sphere else None,
                         seconds_per_100=seconds_per_100(sphere)),
        stage_a=curve_summary(stage_a, STAGE_A_KEYS),
        stage_b=curve_summary(stage_b, STAGE_B_KEYS) if stage_b is not None else None,
        yardstick=yard,
        jax=dict(stage_a=at_steps([r for r in jax[yard][0] if "d" in r], STAGE_A_KEYS),
                 stage_b=at_steps(jax[yard][1], STAGE_B_KEYS)),
        beta=beta,
        probe_a=probe_summary(commands["probe_a"]["lines"]),
        probe_b=probe_summary(lines("probe_b")) if "probe_b" in commands else None,
        checkpoint_probes=read_rows(probes_path),
        mesh=meshes, fid=fid[-1] if fid else None, stage_c=stage_c,
        seconds={name: c["seconds"] for name, c in commands.items()})
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
