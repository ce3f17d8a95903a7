"""``python -m sdface_gan_tpu_torch.prepare_data`` and
``python -m sdface_gan_tpu_torch.train`` on the CPU at a tiny size.

The config is a yaml file that inherits ``configs/256res/ffhq_256_sdf.yaml``
and shrinks it through ``rendering:`` and ``train_args:``; the store is
prepared by the port from PNG files.  Each run works in a temporary
directory holding a ``configs`` symlink, so ``./out/<exp>`` lands there and
``inherit_from: configs/...`` resolves as it does from the repository root.
"""

import json
import math
import os
import time
import types

import numpy as np
import pytest
import torch

from sdface_gan_tpu_torch import prepare_data as prepare_cli
from sdface_gan_tpu_torch import train as train_cli
from sdface_gan_tpu_torch.data.png import encode_png
from sdface_gan_tpu_torch.training import loop
from sdface_gan_tpu_torch.utils import checkpoints
from test_torch_port_training import _two_threads  # noqa: E402,F401  (autouse: two threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = """inherit_from: configs/256res/ffhq_256_sdf.yaml
training:
  out_dir: out/{exp}
data:
  img_size: 16
rendering:
  width: 16
  depth: 2
  N_samples: 4
{extra}train_args:
  renderer_spatial_output_dim: 8
  size: 16
  style_dim: 16
  channel_multiplier: 1
"""


def _write_config(ws, exp, extra=""):
    """``extra`` lines go into the ``rendering:`` section."""
    path = ws / f"{exp}.yaml"
    path.write_text(TINY.format(exp=exp, extra=extra))
    return str(path.name)


def _args(config, *more, device="cpu"):
    args = ["--config", config, "--sdf", "1", "--dataset_path", "store", "--batch", "2",
            "--sphere_init_iters", "2", "--iters", "2", "--log_every", "1",
            "--save_every", "1000", "--sample_every", "1000", *more]
    return args + (["--device", device] if device else [])


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A workspace with a ``configs`` symlink, six non-square PNGs and a
    store prepared from them by the port's CLI."""
    root = tmp_path_factory.mktemp("cli")
    os.symlink(os.path.join(REPO, "configs"), root / "configs")
    (root / "imgs").mkdir()
    rng = np.random.default_rng(0)
    for i in range(6):
        img = rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)
        (root / "imgs" / f"{i:03d}.png").write_bytes(encode_png(img))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        prepare_cli.main(["imgs", "--out", "store", "--size", "16", "--n_worker", "1"])
    return root


@pytest.fixture(autouse=True)
def _in_ws(ws, monkeypatch):
    monkeypatch.chdir(ws)


@pytest.fixture(scope="module")
def trained(ws):
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(ws)
        train_cli.main(_args(_write_config(ws, "tiny")))
    return ws / "out" / "tiny"


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _files(root):
    return {os.path.join(d, n): os.stat(os.path.join(d, n)).st_mtime_ns
            for d, _, names in os.walk(root) for n in names}


def test_prepare_cli_writes_the_store(ws):
    from sdface_gan_tpu_torch.native import RecordReader

    with RecordReader(str(ws / "store")) as r:
        assert r.get("length") == b"6"
        assert sorted(r.keys()) == sorted([f"16-{i:05d}" for i in range(6)] + ["length"])


def test_both_stages_write_their_artifacts(trained):
    vr = trained / "volume_renderer"
    for name in ("sdf_init_models", "vol_renderer"):
        assert checkpoints.checkpoint_exists(str(vr), name), name
    assert checkpoints.checkpoint_exists(str(trained), "full_pipeline")
    rows_a = [r for r in _rows(vr / "vol_render_metrics.jsonl") if "g" in r]
    rows_b = _rows(trained / "full_pipeline_metrics.jsonl")
    assert [r["step"] for r in rows_a] == [0, 1] and [r["step"] for r in rows_b] == [0, 1]
    for r in rows_a + rows_b:
        assert "d_ms" in r and "g_ms" in r
        assert all(math.isfinite(v) for v in r.values()), r


def test_rerun_trains_nothing(trained, capsys):
    before = _files(trained)
    train_cli.main(_args("tiny.yaml"))
    assert _files(trained) == before
    assert "resumed" not in capsys.readouterr().out


def test_the_entry_turns_tf32_off(trained, monkeypatch, capsys):
    """The entry trains at the precision the card-vs-CPU parity holds: f32
    without TF32, whatever the process had set."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    train_cli.main(_args("tiny.yaml"))
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert "precision: f32 matmuls and convolutions without TF32" in capsys.readouterr().out


def _fast_clock(monkeypatch):
    """The loops' clock jumps 100 s a reading, so ``--exit-after 1`` cuts
    after the first iteration."""
    ticks = iter(range(0, 10 ** 9, 100))
    monkeypatch.setattr(loop, "time", types.SimpleNamespace(
        time=lambda: float(next(ticks)), perf_counter=time.perf_counter))


def test_exit_after_exits_with_code_3_and_the_next_run_resumes(ws, monkeypatch, capsys):
    config = _write_config(ws, "tiny_cut")
    vr = str(ws / "out" / "tiny_cut" / "volume_renderer")
    with monkeypatch.context() as mp:
        _fast_clock(mp)
        with pytest.raises(SystemExit) as exc:
            train_cli.main(_args(config, "--exit-after", "1"))
    assert exc.value.code == 3
    assert checkpoints.latest_checkpoint_step(vr) == 0
    assert not checkpoints.checkpoint_exists(vr, "vol_renderer")
    capsys.readouterr()
    train_cli.main(_args(config))
    assert "resumed volume renderer at step 1" in capsys.readouterr().out
    rows = _rows(os.path.join(vr, "vol_render_metrics.jsonl"))
    assert [r["step"] for r in rows if "g" in r] == [0, 1]
    assert sum("sdf_init_loss" in r for r in rows) == 1  # no second sphere init
    assert checkpoints.checkpoint_exists(vr, "vol_renderer")
    assert checkpoints.checkpoint_exists(str(ws / "out" / "tiny_cut"), "full_pipeline")


def test_wod_starts_stage_b_from_the_sphere_init(ws, monkeypatch):
    """``--wod 1`` skips stage A; stage B starts from ``sdf_init_models``,
    which a (cut) stage-A run of the same experiment wrote, and keeps that
    renderer frozen.  Without it, the loop's not-found error."""
    config = _write_config(ws, "tiny_wod")
    out = ws / "out" / "tiny_wod"
    with pytest.raises(FileNotFoundError, match="sdf_init_models"):
        train_cli.main(_args(config, "--wod", "1"))
    with monkeypatch.context() as mp:
        _fast_clock(mp)
        with pytest.raises(SystemExit):
            train_cli.main(_args(config, "--exit-after", "1"))
    train_cli.main(_args(config, "--wod", "1"))
    assert not checkpoints.checkpoint_exists(str(out / "volume_renderer"), "vol_renderer")
    init = checkpoints.load_checkpoint(str(out / "volume_renderer"), "sdf_init_models")
    final = checkpoints.load_checkpoint(str(out), "full_pipeline")
    renderer_keys = [k for k in init["g_ema"] if k.startswith("renderer.")]
    assert renderer_keys
    for k in renderer_keys:
        assert torch.equal(final["g"][k], init["g_ema"][k]), k


@pytest.mark.parametrize("case", ["sdf0", "vae", "psp"])
def test_paths_not_ported_raise(ws, case):
    """``--sdf 0`` on an SDF yaml takes the GIRAFFE family's path (the
    yaml's ``method``, GIRAFFE by default, as the root ``train.py``
    dispatches), with or without stage C's flags (stage C of the SDF flow
    trains in ``tests/test_torch_port_stage_c.py``; GIRAFFE's ``--vae 1`` in
    ``tests/test_torch_port_giraffe_training.py``).  That path reads the
    yaml's image glob, which matches no image here: it raises before
    anything is written."""
    config = _write_config(ws, f"tiny_{case}")
    more = {"sdf0": [], "vae": ["--vae", "1"], "psp": ["--psp", "1"]}[case]
    args = _args(config, *more)
    args[args.index("--sdf") + 1] = "0"
    with pytest.raises(IOError, match="no images match data/ffhq/images"):
        train_cli.main(args)
    assert not (ws / "out" / f"tiny_{case}").exists()


# a small hash grid for the NGP runs (the field's width is its style_dim, 16)
NGP_GRID = "  num_levels: 2\n  level_dim: 2\n  finest_res: 32\n  log2_hashmap_size: 10\n"


@pytest.mark.parametrize("case", ["ngp_flag", "ngp_yaml"])
def test_ngp_trains_both_stages(ws, case):
    """NGP by ``--ngp 1`` or by the yaml's ``rendering: type: ngp``: sphere
    init, stage A with the hash-grid smoothness term, then stage B; both
    artifacts carry the hash table, and every logged loss is finite."""
    extra = NGP_GRID + ("  type: ngp\n" if case == "ngp_yaml" else "")
    config = _write_config(ws, f"tiny_{case}", extra=extra)
    train_cli.main(_args(config, *(["--ngp", "1"] if case == "ngp_flag" else [])))
    out = ws / "out" / f"tiny_{case}"
    vr = out / "volume_renderer"
    rows_a = [r for r in _rows(vr / "vol_render_metrics.jsonl") if "g" in r]
    assert [r["step"] for r in rows_a] == [0, 1]
    for r in rows_a + _rows(out / "full_pipeline_metrics.jsonl"):
        assert all(math.isfinite(v) for v in r.values()), r
    assert all(r["g_smooth"] > 0 for r in rows_a)
    for d, name in ((vr, "vol_renderer"), (out, "full_pipeline")):
        state = checkpoints.load_checkpoint(str(d), name)["g_ema"]
        assert state["renderer.network.encoder.embeddings"].shape[1] == 2, name


def test_the_default_device_refuses_a_missing_card(ws):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(_args(_write_config(ws, "tiny_nocard"), device=None))
    assert not (ws / "out" / "tiny_nocard").exists()
