"""The port's data-parallel loop and entry points on gloo process groups of
two CPU ranks (``torch_parallel_ranks``): stage A's loop against one rank,
its ``--exit-after`` cut decided on rank 0's clock, its resume; and the
``train``, ``eval`` and ``sdf_mesh`` CLIs under ``python -m
torch.distributed.run --nproc_per_node 2 ... --device cpu``.  The steps
themselves are held against JAX's mesh in ``test_torch_port_parallel.py``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdface_gan_tpu_torch.models import discriminator  # noqa: E402
from sdface_gan_tpu_torch.training import steps  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from test_torch_port_training import _configs_a, _two_threads  # noqa: E402,F401

GLOBAL, RES = 8, 8
HP = steps.TrainHParams(batch=GLOBAL, style_dim=16)


def _rng(seed):
    return np.random.default_rng(seed)


def _uniform(seed, *shape):
    return _rng(seed).uniform(-1, 1, shape).astype(np.float32)


# ---------------------------------------------------------------------------
# The stage-A loop over two ranks
# ---------------------------------------------------------------------------

def _loop_payload(out_dir, iters, exit_after=None):
    """Stage A at global batch 8 over one repeated batch (a resumed loader
    starts from its first batch again)."""
    _, pa = _configs_a()
    batch = (_uniform(50, GLOBAL, 16, 16, 3), _uniform(60, GLOBAL, RES, RES, 3))
    return dict(gcfg=pa, dcfg=discriminator.VolumeRenderDiscConfig(in_res=RES), hp=HP,
                batches=[batch] * iters, batch=GLOBAL, out_dir=str(out_dir), iters=iters,
                sphere_init_iters=2, exit_after=exit_after)


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_stage_a_loop_over_two_ranks_matches_one_rank(tmp_path):
    """``train_volume_renderer``, 2 iterations after a 2-step sphere init, on
    2 ranks against 1 rank: an ``exit_after`` that only rank 0's clock
    passes cuts both ranks at step 0 (exit 3 on both, one checkpoint), the
    next run resumes at step 1; rank 0 alone writes (one row per step); the
    logged losses equal the one-rank run's."""
    one_dir, two_dir = tmp_path / "one", tmp_path / "two"
    assert ranks.run_loop(None, _loop_payload(one_dir, 2))["code"] == 0
    res = ranks.spawn("loop", 2, _loop_payload(two_dir, 2, exit_after=[0.0, 1e9]))
    assert [r["code"] for r in res] == [3, 3]
    assert sorted(p.name for p in two_dir.glob("models_*")) == ["models_0000000.pt"]
    res = ranks.spawn("loop", 2, _loop_payload(two_dir, 2))
    assert [r["code"] for r in res] == [0, 0]
    assert (two_dir / "vol_renderer.pt").exists()
    adv = lambda d: [r for r in _rows(d / "vol_render_metrics.jsonl") if "d" in r]  # noqa: E731
    one, two = adv(one_dir), adv(two_dir)
    assert [r["step"] for r in two] == [0, 1] == [r["step"] for r in one]
    for a, b in zip(one, two):
        for k in ("d", "g", "r1", "g_eikonal", "g_minimal_surface", "d_view", "beta"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# The CLIs under the launcher
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = """inherit_from: configs/256res/ffhq_256_sdf.yaml
training:
  out_dir: out/tiny_ddp
data:
  img_size: 16
rendering:
  width: 16
  depth: 2
  N_samples: 4
train_args:
  renderer_spatial_output_dim: 8
  size: 16
  style_dim: 16
  channel_multiplier: 1
"""


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def _launch(ws, module, *args, nproc=2):
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc_per_node", str(nproc), "-m", module, *args,
                           "--device", "cpu"], cwd=ws, env=_env(), capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _workspace(ws, *experiments):
    """The configs (``tiny.yaml`` and one yaml per further experiment, each
    its own ``out_dir``) and a 16^2 store of 8 images in ``ws``."""
    from sdface_gan_tpu_torch.data.prepare import prepare_data
    from sdface_gan_tpu_torch.utils.images import write_png

    os.makedirs(ws / "configs")
    os.symlink(os.path.join(REPO, "configs", "256res"), ws / "configs" / "256res")
    os.symlink(os.path.join(REPO, "configs", "default.yaml"), ws / "configs" / "default.yaml")
    (ws / "configs" / "tiny.yaml").write_text(TINY)
    for exp in experiments:
        (ws / "configs" / f"{exp}.yaml").write_text(
            f"inherit_from: configs/tiny.yaml\ntraining:\n  out_dir: out/{exp}\n")
    imgs = ws / "imgs"
    os.makedirs(imgs)
    for i in range(8):
        write_png(str(imgs / f"{i}.png"),
                  (_rng(70 + i).random((16, 16, 3)) * 255).astype(np.uint8))
    prepare_data(str(imgs), str(ws / "store"), sizes=(16,), n_workers=1)


TRAIN_ARGS = ("--sdf", "1", "--dataset_path", "store", "--batch", "4", "--sphere_init_iters",
              "2", "--iters", "2", "--log_every", "1", "--sample_every", "0")


def test_train_eval_and_sdf_mesh_clis_under_the_launcher(tmp_path):
    """``train`` (sphere init, stages A and B), ``eval`` and ``sdf_mesh`` as
    ``torch.distributed.run --nproc_per_node 2 ... --device cpu`` runs them:
    a gloo group of two ranks, rank 0 writing."""
    ws = tmp_path
    _workspace(ws)
    out = _launch(ws, "sdface_gan_tpu_torch.train", "--config", "configs/tiny.yaml", *TRAIN_ARGS)
    assert "rank 1 of 2 on cpu (gloo)" in out
    exp = ws / "out" / "tiny_ddp"
    assert (exp / "full_pipeline.pt").exists()
    assert len(_rows(exp / "full_pipeline_metrics.jsonl")) == 2
    _launch(ws, "sdface_gan_tpu_torch.eval", "--config", "configs/tiny.yaml", "--n_images",
            "6", "--batch", "4", "--no_fid")
    assert sorted(os.listdir(exp / "eval")) == [f"{i:07d}.png" for i in range(6)]
    _launch(ws, "sdface_gan_tpu_torch.sdf_mesh", "--config", "configs/tiny.yaml",
            "--identities", "1", "--surface_res", "8")
    assert len(os.listdir(exp / "renders")) == 16
    assert os.path.exists(exp / "meshes")


def test_train_under_the_launcher_at_world_one_logs_the_plain_runs_losses(tmp_path):
    """``train`` under ``torch.distributed.run --nproc_per_node 1`` (a gloo
    group of one rank: every collective of the step runs) logs, row by row
    through sphere init, stage A and stage B, the losses of the same
    command without the launcher (rel 1e-6)."""
    ws = tmp_path
    _workspace(ws, "plain", "world1")
    plain = subprocess.Popen([sys.executable, "-m", "sdface_gan_tpu_torch.train", "--config",
                              "configs/plain.yaml", *TRAIN_ARGS, "--device", "cpu"], cwd=ws,
                             env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    try:
        out = _launch(ws, "sdface_gan_tpu_torch.train", "--config", "configs/world1.yaml",
                      *TRAIN_ARGS, nproc=1)
        stdout, stderr = plain.communicate(timeout=240)
    finally:
        if plain.poll() is None:
            plain.kill()
            plain.wait()
    assert plain.returncode == 0, stdout[-3000:] + stderr[-3000:]
    assert "data-parallel mesh" not in stdout
    assert "rank 0 of 1 on cpu (gloo)" in out
    for name in ("volume_renderer/vol_render_metrics.jsonl", "full_pipeline_metrics.jsonl"):
        plain, world1 = (_rows(ws / "out" / e / name) for e in ("plain", "world1"))
        assert [r["step"] for r in world1] == [r["step"] for r in plain] and plain
        for a, b in zip(plain, world1):
            assert set(a) == set(b)
            for k, v in a.items():
                if k not in ("step", "time") and not k.endswith("_ms"):
                    np.testing.assert_allclose(b[k], v, rtol=1e-6, atol=0, err_msg=f"{name} {k}")
