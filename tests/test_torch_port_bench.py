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
  (``configs/64res/synthetic_64_sdf_solid_eik.yaml``, narrowed), at the
  smallest counts the entries accept.
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


TINY_64 = """inherit_from: configs/64res/synthetic_64_sdf_solid_eik.yaml
training:
  out_dir: out/tiny64
rendering:
  width: 16
  depth: 2
  N_samples: 4
  eikonal_subsample: 64
train_args:
  style_dim: 16
  channel_multiplier: 1
"""


def test_convergence_script_runs_the_64_configs_end_to_end(tmp_path):
    """The store, both stages and every judge at the smallest counts: the
    64^2 thumbs through a decoder that does not upsample, ``bg_mode: gray``,
    ``view_independent``, ``sparsity_lambda``, the subsampled eikonal and a
    bf16 G (narrowed widths; depth and widths only are cut)."""
    (tmp_path / "tiny64.yaml").write_text(TINY_64)
    out = tmp_path / "report"
    proc = subprocess.run(
        [sys.executable, SCRIPT, "--config", "tiny64.yaml", "--store_images", "12",
         "--batch", "2", "--iters", "3", "--sphere_init_iters", "2", "--log_every", "1",
         "--probe_identities", "2", "--probe_res", "16", "--surface_res", "16",
         "--eval_images", "8", "--out_dir", str(out), "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
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
    assert set(summary["seconds"]) == {"store", "train", "probe_a", "probe_b", "sdf_mesh",
                                       "eval"}
    for name in ("vol_render_metrics.jsonl", "full_pipeline_metrics.jsonl", "train.log",
                 "eval.log"):
        assert (out / name).exists(), name
    # the 64^2 path: the store at 64^2, a stage-B image at 64^2 (no upsampling)
    from sdface_gan_tpu_torch.native import RecordReader

    with RecordReader(str(tmp_path / "data/synthetic_flat/records")) as r:
        assert r.get("length") == b"12" and "64-00011" in list(r.keys())
    assert (tmp_path / "out/tiny64/full_pipeline.pt").exists()


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
