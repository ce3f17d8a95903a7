"""The port's benches (``python -m sdface_gan_tpu_torch.bench`` /
``bench_ngp``) and the staged convergence run
(``scripts/torch_convergence_run.py``) on the CPU, at small sizes.

* ``bench``'s timed call (``SDFaceSampler.sample``, no truncation), on
  weights converted from JAX, against JAX ``generator_forward`` on the same
  bf16-cast weights, z and cameras (a fixed viewpoint), under the
  bf16 contract of ``tests/test_ops.py:346-381`` (its error against the f32
  truth at most 1.2x the JAX bf16 forward's + 1e-4); its JSON line carries
  the keys of the repository's ``bench.py``;
* ``bench_ngp``'s functions at tiny sizes, each line under the JAX bench's
  metric name; the forward and table gradient it times against JAX
  ``hash_encode`` and ``jax.grad`` of it (the hash-grid tolerances of
  ``test_torch_port_ngp_training.py``);
* the convergence script end to end over the 64^2 configs
  (``configs/64res/synthetic_64_sdf_solid_eik.yaml`` and its ``_s1`` arm,
  narrowed), at the smallest counts the entries accept: split at the
  stage-A artifact, the seed passed on, every stage-A checkpoint probed,
  the JAX run of the config as the yardstick, both stage-C legs.
"""

import ast
import json
import math
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdface_gan_tpu.geometry import generate_camera_params as j_cams  # noqa: E402
from sdface_gan_tpu.models import generator as j_gen  # noqa: E402
from sdface_gan_tpu.ops import hash_encoder as jh  # noqa: E402
from sdface_gan_tpu_torch import bench, bench_ngp  # noqa: E402
from sdface_gan_tpu_torch.models.generator import Generator  # noqa: E402
from sdface_gan_tpu_torch.ops import hash_encoder as ph  # noqa: E402
from sdface_gan_tpu_torch.serving import SDFaceSampler  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import jax_params_to_state_dict  # noqa: E402

from test_torch_port_models import IMAGE_TOL, RES, _configs  # noqa: E402
from test_torch_port_training import _two_threads  # noqa: E402,F401  (autouse: two threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_convergence_run.py")
HASH_GRIDS = {
    "small": dict(num_levels=4, level_dim=2, base_resolution=4, desired_resolution=64,
                  log2_hashmap_size=7),
    "upstream": dict(num_levels=16, level_dim=2, desired_resolution=4096,
                     log2_hashmap_size=19),
}


def _jax_bench_keys(path: str) -> set:
    """The constant keys of the dict that the JAX bench's ``main`` prints."""
    tree = ast.parse(open(path).read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    dicts = [n for n in ast.walk(main) if isinstance(n, ast.Dict)]
    return {k.value for d in dicts for k in d.keys if isinstance(k, ast.Constant)}


def _tiny_flagship():
    """``bench.flagship_config`` narrowed to the shapes of
    ``test_torch_port_models.py``."""
    _, pcfg = _configs()
    return pcfg


AZIM, ELEV = 0.2, -0.1  # a fixed viewpoint: the same cameras in both packages


@pytest.fixture(scope="module")
def converted():
    jcfg, pcfg = _configs()
    params = j_gen.init_generator(jax.random.PRNGKey(0), jcfg)
    state = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), pcfg)
    cams = j_cams(RES, None, locations=jnp.asarray([[AZIM, ELEV]] * 2, jnp.float32))
    z = np.random.default_rng(3).standard_normal((2, pcfg.style_dim)).astype(np.float32)
    return dict(jcfg=jcfg, pcfg=pcfg, params=params, state=state, cams=cams, z=z)


def _port_forward(converted, dtype):
    """``bench``'s timed call on the converted weights, without the depth
    jitter (JAX's eval mode)."""
    pcfg = converted["pcfg"]
    model = Generator(replace(pcfg, renderer=replace(pcfg.renderer, perturb=0.0)), device="cpu")
    model.load_state_dict(converted["state"])
    sampler = SDFaceSampler(model.to(dtype), batch=2, truncation=bench.TRUNCATION)
    return sampler.sample(z=converted["z"], azim=AZIM, elev=ELEV).float().numpy()


def _jax_forward(converted, params):
    c = converted["cams"]
    out = j_gen.generator_forward(params, converted["jcfg"], [jnp.asarray(converted["z"])],
                                  c.extrinsics, c.focal, c.near, c.far, key=None,
                                  randomize_noise=False)
    return np.asarray(out.rgb.astype(jnp.float32))


def test_bench_forward_matches_jax_in_f32(converted):
    """The converted weights and the serving forward are the JAX model's."""
    np.testing.assert_allclose(_port_forward(converted, torch.float32),
                               _jax_forward(converted, converted["params"]), **IMAGE_TOL)


def test_bench_forward_meets_the_bf16_contract(converted):
    """bf16 weights as ``bench.py:45-50`` casts them: the port's image is no
    further from the f32 truth than JAX's bf16 image is, by the rule of
    ``tests/test_ops.py:346-381``."""
    truth = _jax_forward(converted, converted["params"])
    p16 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x, converted["params"])
    err_jax = np.mean(np.abs(_jax_forward(converted, p16) - truth))
    err_port = np.mean(np.abs(_port_forward(converted, torch.bfloat16) - truth))
    assert 0 < err_jax and err_port <= 1.2 * err_jax + 1e-4, (err_port, err_jax)


def test_bench_prints_one_line_with_the_jax_bench_keys(monkeypatch, capsys):
    monkeypatch.setattr(bench, "flagship_config", _tiny_flagship)
    monkeypatch.setattr(bench, "BATCH", 2)
    monkeypatch.setattr(bench, "ITERS", 3)
    record = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert _jax_bench_keys(os.path.join(REPO, "bench.py")) <= set(record)
    assert {"device", "iter_ms_median", "iter_ms_max"} <= set(record)
    assert record["device"] == "cpu" and record["unit"] == "images/sec"
    assert len(record["iter_ms"]) == 3 and record["iter_ms_max"] >= record["iter_ms_median"]
    assert record["value"] > 0 and record["finite"] and record["shape"] == [2, 32, 32, 3]
    assert record["vs_baseline"] == pytest.approx(record["value"] / 2.5, abs=1e-3)  # 3 places
    assert "siren_field_mma_kernel<256>" in record["metric"]


def test_the_flagship_is_the_entry_model():
    """``__graft_entry__.py:27-34``: 256^2, style 256, width 256, depth 8,
    64^2 x 24 samples."""
    cfg = bench.flagship_config()
    r = cfg.renderer
    assert (cfg.size, cfg.style_dim, cfg.full_pipeline) == (256, 256, True)
    assert (r.type, r.width, r.depth, r.out_im_res, r.n_samples) == ("sdf", 256, 8, 64, 24)
    assert (bench.BATCH, bench.WARMUP, bench.ITERS) == (32, 2, 10)


def test_benches_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.run_bench(_tiny_flagship(), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_ngp.bench_hash_fwd_bwd(8)


@pytest.mark.parametrize("grid", list(HASH_GRIDS))
def test_bench_ngp_hash_functions_match_jax(grid):
    """The forward, the table gradient of sum(encode^2) and the sorted
    prototype that ``bench_hash_fwd_bwd`` times, on a std-1 table."""
    jspec, pspec = (m.HashGridSpec.create(**HASH_GRIDS[grid]) for m in (jh, ph))
    x, table = bench_ngp.hash_inputs(pspec, 300, "cpu", seed=5, std=1.0)
    fns = bench_ngp.hash_functions(x, table, pspec)
    jx, jt = jnp.asarray(x.numpy()), jnp.asarray(table.numpy())
    ref = jh.hash_encode(jx, jt, jspec)
    ref_grad = jax.grad(lambda t: jnp.sum(jh.hash_encode(jx, t, jspec) ** 2))(jt)
    ref_sorted = jh.hash_encode_vjp_sorted(jx, jt, jspec, ref)
    for ours, want in ((fns["forward"](), ref), (fns["table_grad"](), ref_grad),
                       (fns["sorted"](), ref_sorted)):
        want = np.asarray(want, dtype=np.float32)
        np.testing.assert_allclose(ours.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * max(np.abs(want).max(), 1e-30))


def test_bench_ngp_lines_carry_the_jax_metric_names(capsys):
    """Each function at a tiny size prints its line; at the JAX bench's
    sizes the names are the JAX bench's own."""
    src = open(os.path.join(REPO, "bench_ngp.py")).read()
    assert f'"{bench_ngp.HASH_METRICS["forward"].format(levels=16)}"' in src
    for name in ("table_grad", "sorted"):
        assert f'"{bench_ngp.HASH_METRICS[name]}"' in src
    assert ("stage-A NGP train step (D+G, batch {batch}, 64^2x24)"
            == bench_ngp.STAGE_A_METRIC.format(batch="{batch}", res=64, samples=24))
    assert 'f"' + bench_ngp.STAGE_A_METRIC.format(batch="{batch}", res=64, samples=24) in src
    assert 'f"' + bench_ngp.SERVING_METRIC in src
    for name in bench_ngp.SERVING_GRIDS:
        assert f'"{name}"' in src
    stage_a = bench_ngp.stage_a_ngp_config()
    assert (stage_a.renderer.ngp_num_levels, stage_a.renderer.remat) == (16, True)

    spec = ph.HashGridSpec.create(**HASH_GRIDS["small"])
    hash_lines = bench_ngp.bench_hash_fwd_bwd(400, "cpu", spec=spec, iters=2)
    gcfg = replace(stage_a, style_dim=16, renderer=replace(
        stage_a.renderer, out_im_res=16, n_samples=4, style_dim=16, width=16,
        ngp_num_levels=2, ngp_finest_res=32, ngp_log2_hashmap_size=10))
    train_line = bench_ngp.bench_stage_a_ngp(2, "cpu", gcfg=gcfg, warmup=1, iters=2)
    grids = {}
    for name, grid in bench_ngp.SERVING_GRIDS.items():
        c = bench_ngp.ngp_serving_config(
            {**grid, "ngp_num_levels": min(grid["ngp_num_levels"], 4), "ngp_finest_res": 32,
             "ngp_log2_hashmap_size": 10}, size=32, style_dim=16)
        grids[name] = replace(c, channel_multiplier=1,
                              renderer=replace(c.renderer, out_im_res=16, n_samples=4, width=16))
    serving_lines = bench_ngp.bench_ngp_serving(2, "cpu", configs=grids, iters=2)
    records = hash_lines + [train_line] + serving_lines
    printed = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert printed == records
    assert [r["metric"] for r in records] == (
        [bench_ngp.HASH_METRICS["forward"].format(levels=4), bench_ngp.HASH_METRICS["table_grad"],
         bench_ngp.HASH_METRICS["sorted"],
         bench_ngp.STAGE_A_METRIC.format(batch=2, res=16, samples=4)]
        + [bench_ngp.SERVING_METRIC.format(name=n) for n in bench_ngp.SERVING_GRIDS])
    assert [r["unit"] for r in records] == ["Mlookups/sec"] * 3 + ["it/sec"] + ["images/sec"] * 3
    for r in records:
        assert r["value"] > 0 and r["device"] == "cpu", r
        assert not any(r["launches"].values()), r  # the CPU runs the plain versions
    for r in hash_lines + serving_lines:  # loops of at least MIN_WINDOW_S, >= iters calls
        assert r["calls"] >= 2 and r["ms"] > 0, r
    assert [r.get("kernel_device_ms") for r in hash_lines[:2]] == [None, None]  # card only
    assert train_line["finite"] and all(r["finite"] for r in serving_lines)
    assert train_line["iter_ms_max"] >= train_line["iter_ms_median"] > 0


TINY_64 = """inherit_from: configs/64res/synthetic_64_sdf_solid_eik{suffix}.yaml
training:
  out_dir: out/tiny64{suffix}
rendering:
  width: 16
  depth: 2
  N_samples: 4
  eikonal_subsample: 64
train_args:
  style_dim: 256
  channel_multiplier: 1
"""
# the smallest counts the entries accept; two stage-A checkpoints to probe
SMALL_RUN = ["--store_images", "12", "--batch", "2", "--iters", "3", "--sphere_init_iters", "2",
             "--log_every", "1", "--probe_identities", "2", "--probe_res", "16",
             "--surface_res", "16", "--eval_images", "8", "--save_every", "1", "--device", "cpu"]
STAGE_C = ["--stage_c", "vae,psp", "--stage_c_iters", "2", "--stage_c_log_every", "1"]


def _convergence_run(cwd, *args):
    proc = subprocess.run([sys.executable, SCRIPT, *SMALL_RUN, *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def convergence_runs(tmp_path_factory):
    """The script at the tiny 64^2 config: seed 0 split as on the card (stage
    A and its judges with ``--stop_after_a``, then the rest with both
    stage-C legs), and seed 1 on the ``_s1`` yaml's narrowing in one go.
    The pSp leg needs ``style_dim: 256``."""
    tmp = tmp_path_factory.mktemp("convergence")
    os.symlink(os.path.join(REPO, "configs"), tmp / "configs")
    for suffix in ("", "_s1"):
        (tmp / f"tiny64{suffix}.yaml").write_text(TINY_64.format(suffix=suffix))
    first = _convergence_run(tmp, "--config", "tiny64.yaml", "--out_dir", "report",
                             "--stop_after_a")
    seed0 = _convergence_run(tmp, "--config", "tiny64.yaml", "--out_dir", "report", *STAGE_C)
    seed1 = _convergence_run(tmp, "--config", "tiny64_s1.yaml", "--seed", "1",
                             "--out_dir", "report_s1")
    return dict(tmp=tmp, first=first, seed0=seed0, seed1=seed1)


def test_convergence_script_runs_the_64_configs_end_to_end(convergence_runs):
    """The store, both stages and every judge at the smallest counts: the
    64^2 thumbs through a decoder that does not upsample, ``bg_mode: gray``,
    ``view_independent``, ``sparsity_lambda``, the subsampled eikonal and a
    bf16 G (narrowed widths; depth and widths only are cut), split at the
    stage-A artifact as the card runs it."""
    tmp, summary = convergence_runs["tmp"], convergence_runs["seed0"]
    out = tmp / "report"
    assert summary == json.load(open(out / "summary.json"))
    for stage, keys in (("stage_a", ("d", "fg_mass", "g_eikonal", "beta")),
                        ("stage_b", ("d", "g", "g_content", "path_length"))):
        s = summary[stage]
        assert s["logged"] == 3 and s["last_step"] == 2 and s["all_finite"], s
        assert set(s["at"]["0"]) == set(keys), s
        assert set(summary["jax"][stage]) == {"0", "1000", "2500", "5000"}
    assert summary["stage_a"]["at"]["0"]["beta"] == pytest.approx(0.1, abs=1e-3)
    for probe in ("probe_a", "probe_b"):
        assert summary[probe]["verdict"] and len(summary[probe]["lines"]) == 2
    assert all("mesh" in ln for ln in summary["probe_b"]["lines"])
    assert len(summary["mesh"]) == 1 and "verts" in summary["mesh"][0]
    fid = summary["fid"].split()
    assert fid[0] == "FID:" and math.isfinite(float(fid[1])) and fid[2] == "KID:"
    # the second half trains stage B only and judges both stages
    assert set(summary["seconds"]) == {"train", "probe_a", "probe_b", "sdf_mesh", "eval",
                                       "stage_c_vae", "stage_c_psp"}
    first = convergence_runs["first"]
    assert first["stage_b"] is None and first["probe_b"] is None and first["fid"] is None
    assert set(first["seconds"]) == {"store", "train", "probe_a", "probe_a_0000001",
                                     "probe_a_0000002"}
    assert first["stage_a"] == summary["stage_a"]
    for name in ("vol_render_metrics.jsonl", "full_pipeline_metrics.jsonl", "train.log",
                 "eval.log"):
        assert (out / name).exists(), name
    # the 64^2 path: the store at 64^2, a stage-B image at 64^2 (no upsampling)
    from sdface_gan_tpu_torch.native import RecordReader

    with RecordReader(str(tmp / "data/synthetic_flat/records")) as r:
        assert r.get("length") == b"12" and "64-00011" in list(r.keys())
    assert (tmp / "out/tiny64/full_pipeline.pt").exists()


def test_convergence_script_passes_the_seed_to_train(convergence_runs):
    """``--seed 1`` reaches ``train``: its stage-A losses differ from seed
    0's at the same config widths, and the train log names the seed."""
    tmp = convergence_runs["tmp"]
    at0 = convergence_runs["seed0"]["stage_a"]["at"]
    at1 = convergence_runs["seed1"]["stage_a"]["at"]
    assert convergence_runs["seed1"]["seed"] == 1 and convergence_runs["seed0"]["seed"] == 0
    for step in ("0",):
        for key in ("d", "fg_mass", "g_eikonal"):
            assert at0[step][key] != at1[step][key], (step, key)
    assert "training tiny64_s1.yaml with seed 1" in (tmp / "report_s1/train.log").read_text()
    assert "training tiny64.yaml with seed 0" in (tmp / "report/train.log").read_text()


def test_convergence_script_probes_every_saved_checkpoint(convergence_runs):
    """``--save_every 1`` saves stage A at steps 1 and 2; each is probed once,
    in the run that wrote it, one line each in ``checkpoint_probes.jsonl``
    (verdict, crossing and sdf range, beta), carried into the summary of the
    run that finished the split."""
    tmp = convergence_runs["tmp"]
    rows = [json.loads(ln) for ln in (tmp / "report/checkpoint_probes.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert convergence_runs["seed0"]["checkpoint_probes"] == rows
    assert convergence_runs["first"]["checkpoint_probes"] == rows
    for r in rows:
        assert r["verdict"] and len(r["lines"]) == 2
        assert r["crossing"][0] <= r["crossing"][1] and r["sdf"][0] <= r["sdf"][1]
        assert r["beta"] == pytest.approx(0.1, abs=1e-3)
    assert [r["step"] for r in convergence_runs["seed1"]["checkpoint_probes"]] == [1, 2]


def test_convergence_script_takes_the_jax_run_of_the_config(convergence_runs):
    """The yardstick is the JAX run of the yaml the config inherits from:
    seed 0's series for ``synthetic_64_sdf_solid_eik.yaml``, seed 1's for
    the ``_s1`` yaml; beta at the yardstick steps stands beside both."""
    for run, name, path in (
            ("seed0", "synthetic_64_sdf_solid_eik.yaml", "training_run_solid_eik_metrics"),
            ("seed1", "synthetic_64_sdf_solid_eik_s1.yaml",
             "training_run_solid_eik_s1_metrics")):
        summary = convergence_runs[run]
        assert summary["yardstick"] == name
        rows = {r["step"]: r for r in map(json.loads, open(os.path.join(
            REPO, "docs", path + ".jsonl"))) if "d" in r}
        assert summary["jax"]["stage_a"]["1000"]["beta"] == rows[1000]["beta"]
        assert set(summary["beta"]["5000"]) == {"synthetic_64_sdf_solid_eik.yaml",
                                                "synthetic_64_sdf_solid_eik_s1.yaml"}
        assert set(summary["beta"]["0"]) == {"port", "synthetic_64_sdf_solid_eik.yaml",
                                             "synthetic_64_sdf_solid_eik_s1.yaml"}


def test_convergence_script_refuses_a_config_without_a_jax_run(tmp_path):
    """A config whose chain holds no JAX run is refused by name before
    anything runs."""
    os.symlink(os.path.join(REPO, "configs"), tmp_path / "configs")
    (tmp_path / "other.yaml").write_text(
        "inherit_from: configs/64res/synthetic_64_sdf.yaml\ntraining:\n  out_dir: out/other\n")
    proc = subprocess.run([sys.executable, SCRIPT, *SMALL_RUN, "--config", "other.yaml"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "other.yaml: no JAX run" in proc.stderr, proc.stderr
    assert not (tmp_path / "data").exists() and not (tmp_path / "out").exists()


@pytest.mark.parametrize("leg", ["vae", "psp"])
def test_convergence_script_stage_c_legs_write_finite_series(convergence_runs, leg):
    """Each stage-C leg trains against the run's own stage-B generator and
    writes its ``e_*`` series, finite, beside JAX's (its fall key: the
    VAE's KL, pSp's full-size L2)."""
    tmp = convergence_runs["tmp"]
    s = convergence_runs["seed0"]["stage_c"][leg]
    assert s["all_finite"] and s["logged"] == 2 and s["last_step"] == 1
    assert set(s["at"]["0"]) == {"e_kl", "e_l2_full", "e_l2_thumb", "e_loss"}
    assert s["fall_key"] == ("e_kl" if leg == "vae" else "e_l2_full") and s["fall"] > 0
    assert set(s["jax"]) == {"0", "1000", "2000", "3000", "4000"}
    rows = [json.loads(ln) for ln in (tmp / f"report/stageC_{leg}_metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(math.isfinite(r[k]) for r in rows for k in s["at"]["0"])
    assert (tmp / ("out/tiny64/encoder_psp" if leg == "psp" else "out/tiny64/encoder")
            / "encoder.pt").exists()


def test_new_entry_files_import_no_jax():
    """The benches are package modules (covered by the serving test's scan);
    the convergence script is checked here."""
    for node in ast.walk(ast.parse(open(SCRIPT).read())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(n.split(".")[0] == "jax" or n == "sdface_gan_tpu"
                       or n.startswith("sdface_gan_tpu.") for n in names), names
