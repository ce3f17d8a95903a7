"""The port's geometry against the JAX package: marching cubes, frustum
alignment, mesh export, depth-map meshes, the rasterizer and noise
projection, the geometry probe, ``sdf_mesh``'s surface probe and view
sweep, the procedural dataset and gradient accumulation; and the
``probe_geometry`` and ``sdf_mesh`` entries once on the CPU.

Both sides take the same numpy inputs drawn from a seed.  The native code
is the port's own copy (``sdface_gan_tpu_torch/native``), built with the
JAX package's flags, so its outputs are held equal, not close.  The
generators come from one reference-layout state dict, as in
``test_torch_port_models.py``.
"""

import os
from collections import Counter
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdface_gan_tpu import native as j_native  # noqa: E402
from sdface_gan_tpu.geometry import generate_camera_params as j_cams  # noqa: E402
from sdface_gan_tpu.geometry import mesh as j_mesh  # noqa: E402
from sdface_gan_tpu.models import generator as j_gen  # noqa: E402
from sdface_gan_tpu.models import noise_projection as j_noise  # noqa: E402
from sdface_gan_tpu.models import renderer as j_rend  # noqa: E402
from sdface_gan_tpu.training.microbatch import accumulate_gradients as j_accumulate  # noqa: E402
from sdface_gan_tpu.utils.torch_import import import_generator_state  # noqa: E402
from sdface_gan_tpu_torch import native, probe_geometry, sdf_mesh  # noqa: E402
from sdface_gan_tpu_torch.config import load_config  # noqa: E402
from sdface_gan_tpu_torch.config.build import generator_config, stage_options  # noqa: E402
from sdface_gan_tpu_torch.data import synthetic  # noqa: E402
from sdface_gan_tpu_torch.data.png import decode_png  # noqa: E402
from sdface_gan_tpu_torch.geometry import mesh  # noqa: E402
from sdface_gan_tpu_torch.geometry.cameras import CameraParams  # noqa: E402
from sdface_gan_tpu_torch.models import noise_projection  # noqa: E402
from sdface_gan_tpu_torch.models.generator import Generator  # noqa: E402
from sdface_gan_tpu_torch.training.loop import copy_matching  # noqa: E402
from sdface_gan_tpu_torch.training.microbatch import accumulate_gradients  # noqa: E402
from sdface_gan_tpu_torch.utils.checkpoints import save_checkpoint  # noqa: E402

from test_torch_import import _build_reference_state  # noqa: E402
from test_torch_port_models import (  # noqa: E402
    DEPTH,
    IMAGE_TOL,
    RES,
    SIZE,
    STYLE,
    WIDTH,
    _configs,
    _port_model,
    _truncation_pair_jax,
    _truncation_pair_port,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_TOL = 1e-4  # probe statistics, each O(1)
SDF_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two threads for torch and BLAS while this module runs: its renders
    otherwise oversubscribe a machine that runs the suite in several
    workers at once."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(2):
            yield
    finally:
        torch.set_num_threads(n)


def _sphere(n, radius=0.5, shape=None):
    shape = shape or (n, n, n)
    axes = [np.linspace(-1, 1, k) for k in shape]
    x, y, z = np.meshgrid(*axes, indexing="ij")
    return (np.sqrt(x ** 2 + y ** 2 + z ** 2) - radius).astype(np.float32)


def _smooth_volume(shape, seed):
    """An SDF-like volume: a wobbly ellipsoid plus small noise."""
    h, w, d = shape
    y, x, z = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w),
                          np.linspace(-1, 1, d), indexing="ij")
    rng = np.random.default_rng(seed)
    v = (np.sqrt((x / 0.7) ** 2 + (y / 0.8) ** 2 + (z / 0.6) ** 2) - 0.8
         + 0.05 * np.sin(3 * x + 2 * y) + 0.01 * rng.standard_normal(x.shape))
    return v.astype(np.float32)


VOLUMES = {
    "sphere": lambda: _sphere(24),
    "sphere_noncubic": lambda: _sphere(0, shape=(20, 14, 11)),
    "random": lambda: np.random.default_rng(0).standard_normal((9, 10, 11)).astype(np.float32),
    "random_level": lambda: np.random.default_rng(1).uniform(-1, 1, (12, 7, 8)).astype(np.float32),
}


@pytest.mark.parametrize("name", list(VOLUMES))
def test_marching_cubes_matches_jax(name):
    vol = VOLUMES[name]()
    level = 0.2 if name == "random_level" else 0.0
    verts, faces = native.marching_cubes(vol, level)
    j_verts, j_faces = j_native.marching_cubes(vol, level)
    assert len(faces) > 0
    np.testing.assert_array_equal(faces, j_faces)
    np.testing.assert_allclose(verts, j_verts, rtol=0, atol=1e-6)


def test_marching_cubes_sphere_is_closed():
    n = 32
    verts, faces = native.marching_cubes(_sphere(n), 0.0)
    r = np.linalg.norm(verts / (n - 1) * 2 - 1, axis=1)
    assert abs(float(r.mean()) - 0.5) < 0.02 and float(r.std()) < 0.01
    edges = Counter()
    for f in faces:
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            edges[(min(a, b), max(a, b))] += 1
    assert set(edges.values()) == {2}


@pytest.mark.parametrize("shape", [(1, 5, 5), (3, 3), (0, 4, 4)])
def test_marching_cubes_refuses_what_jax_refuses(shape):
    vol = np.zeros(shape, np.float32)
    with pytest.raises(ValueError) as ours:
        native.marching_cubes(vol)
    with pytest.raises(ValueError) as theirs:
        j_native.marching_cubes(vol)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("shape,channels,batch", [((16, 12, 10), 1, 1), ((9, 13, 7), 3, 2)])
def test_align_volume_matches_jax(shape, channels, batch):
    vol = np.stack([np.stack([_smooth_volume(shape, 10 * b + c) for c in range(channels)], -1)
                    for b in range(batch)])
    ours = mesh.align_volume(torch.from_numpy(vol)).numpy()
    ref = np.asarray(j_mesh.align_volume(jnp.asarray(vol)))
    assert ours.shape == ref.shape == vol.shape
    np.testing.assert_array_equal(ours == 1.0, ref == 1.0)  # the out-of-frustum cells
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_extract_mesh_exports_the_same_bytes(tmp_path):
    sdf = _sphere(0, radius=0.45, shape=(18, 16, 14))[None, ..., None]
    ours = mesh.extract_mesh_with_marching_cubes(sdf)
    ref = j_mesh.extract_mesh_with_marching_cubes(sdf)
    assert len(ours.faces) > 100
    for ext in ("obj", "ply"):
        getattr(ours, f"export_{ext}")(str(tmp_path / f"ours.{ext}"))
        getattr(ref, f"export_{ext}")(str(tmp_path / f"ref.{ext}"))
        assert (tmp_path / f"ours.{ext}").read_bytes() == (tmp_path / f"ref.{ext}").read_bytes()


def test_xyz2mesh_matches_jax():
    xyz = np.random.default_rng(2).standard_normal((1, 7, 7, 3)).astype(np.float32)
    ours, ref = mesh.xyz2mesh(xyz), j_mesh.xyz2mesh(xyz)
    np.testing.assert_array_equal(ours.faces, ref.faces)
    np.testing.assert_array_equal(ours.verts, ref.verts)


def _projected_mesh(seed, res):
    rng = np.random.default_rng(seed)
    verts = np.concatenate([rng.uniform(0, res, (40, 2)), rng.uniform(0.5, 2.0, (40, 1))], 1)
    faces = rng.integers(0, 40, (60, 3))
    return verts.astype(np.float32), faces.astype(np.int32), rng.standard_normal(40).astype(
        np.float32)


@pytest.mark.parametrize("seed,res", [(0, 16), (1, 33)])
def test_raster_mesh_matches_jax(seed, res):
    args = _projected_mesh(seed, res) + (res, res + 3)
    attr, depth = native.raster_mesh(*args)
    j_attr, j_depth = j_native.raster_mesh(*args)
    assert (depth < 1e29).any()
    np.testing.assert_array_equal(attr, j_attr)
    np.testing.assert_array_equal(depth, j_depth)


def _face_mesh(cls):
    sdf = _sphere(0, radius=0.6, shape=(14, 14, 14))[None, ..., None]
    return cls.extract_mesh_with_marching_cubes(sdf)


def test_subdivide_matches_jax():
    m = _face_mesh(mesh)
    ours = noise_projection.subdivide(m.verts, m.faces)
    ref = j_noise.subdivide(m.verts, m.faces)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("resolution", [64, 256])
def test_noise_projection_matches_jax(resolution):
    azim, elev = 0.2, -0.1
    loc = np.array([np.cos(elev) * np.sin(azim), np.sin(elev), np.cos(elev) * np.cos(azim)])
    z_axis = loc / np.linalg.norm(loc)
    x_axis = np.cross([0.0, 1.0, 0.0], z_axis)
    x_axis /= np.linalg.norm(x_axis)
    y_axis = np.cross(z_axis, x_axis)
    extr = np.concatenate([np.stack([x_axis, y_axis, z_axis], 1), loc[:, None]], 1)
    ours = noise_projection.NoiseProjector(_face_mesh(mesh), seed=3)
    ref = j_noise.NoiseProjector(_face_mesh(j_mesh), seed=3)
    a = ours.project(extr.astype(np.float32), resolution)
    b = ref.project(extr.astype(np.float32), resolution)
    assert a.shape == (resolution, resolution, 1)
    np.testing.assert_array_equal(a, b)
    on_surface = ours.project(extr, resolution, prev_noise=np.zeros((resolution, resolution)))
    assert 0.01 < np.mean(on_surface != 0) < 0.9  # the mesh covers part of the image
    for x, y in zip(ours.decoder_noise(extr, [32, 64]), ref.decoder_noise(extr, [32, 64])):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [{}, {"uniform": True, "flat_bg": 0.5},
                                {"azim_range": 0.5, "elev_range": 0.3}])
def test_render_head_is_bit_equal(kw):
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "make_synthetic_dataset.py"
    spec = importlib.util.spec_from_file_location("make_synthetic_dataset", path)
    make_synthetic_dataset = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make_synthetic_dataset)

    for seed in (0, 5):
        ours = synthetic.render_head(np.random.default_rng(seed), 24, **kw)
        ref = make_synthetic_dataset.render_head(np.random.default_rng(seed), 24, **kw)
        np.testing.assert_array_equal(ours, ref)


def test_synthetic_cli_writes_the_store(tmp_path):
    out = tmp_path / "store"
    synthetic.main(["--out", str(out), "--n", "5", "--res", "16", "--seed", "2"])
    rng = np.random.default_rng(2)
    with native.RecordReader(str(out)) as r:
        assert r.get("length") == b"5"
        for i in range(5):
            want = (synthetic.render_head(rng, 16) * 255).astype(np.uint8)
            np.testing.assert_array_equal(decode_png(r.get(f"16-{i:05d}")), want)
    assert sorted(p.name for p in (tmp_path / "store_png").iterdir())[0] == "000000.png"


def _mlp_case(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w1": rng.standard_normal((5, 8)).astype(np.float32) * 0.5,
              "b1": rng.standard_normal(8).astype(np.float32) * 0.1,
              "w2": rng.standard_normal((8, 2)).astype(np.float32) * 0.5}
    batch = {"x": rng.standard_normal((12, 5)).astype(np.float32),
             "y": rng.standard_normal((12, 2)).astype(np.float32)}
    return params, batch


@pytest.mark.parametrize("n_chunks", [1, 3, 4])
def test_accumulate_gradients_matches_jax(n_chunks):
    params, batch = _mlp_case()

    def j_loss(p, b):
        h = jnp.tanh(b["x"] @ p["w1"] + p["b1"])
        err = h @ p["w2"] - b["y"]
        return jnp.mean(err ** 2), {"max": jnp.max(jnp.abs(err))}

    def loss(p, b):
        h = torch.tanh(b["x"] @ p["w1"] + p["b1"])
        err = h @ p["w2"] - b["y"]
        return torch.mean(err ** 2), {"max": torch.max(torch.abs(err))}

    j_grads, j_mean, j_aux = j_accumulate(j_loss, jax.tree_util.tree_map(jnp.asarray, params),
                                          jax.tree_util.tree_map(jnp.asarray, batch), n_chunks)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    grads, mean, aux = accumulate_gradients(
        loss, tp, {k: torch.from_numpy(v) for k, v in batch.items()}, n_chunks)
    assert set(grads) == set(params)
    for k in params:
        ref = np.asarray(j_grads[k])
        err = np.linalg.norm(grads[k].numpy() - ref)
        assert err <= 1e-6 * np.linalg.norm(ref), (k, err)
    np.testing.assert_allclose(float(mean), float(j_mean), rtol=1e-6)
    np.testing.assert_allclose(float(aux["max"].detach()), float(j_aux["max"]), rtol=1e-6)


def test_accumulate_gradients_takes_sequences():
    params, batch = _mlp_case(1)
    tp = [torch.from_numpy(params[k]).requires_grad_(True) for k in ("w1", "b1", "w2")]
    xs = (torch.from_numpy(batch["x"]), torch.from_numpy(batch["y"]))

    def loss(p, b):
        return torch.mean((torch.tanh(b[0] @ p[0] + p[1]) @ p[2] - b[1]) ** 2), None

    grads, _, _ = accumulate_gradients(loss, tp, xs, 4)
    whole = torch.autograd.grad(loss(tp, xs)[0], tp)
    for g, w in zip(grads, whole):  # equal chunks: the mean of means is the mean
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-7)


# ------------------------------------------------- generator-side tools vs JAX

@pytest.fixture(scope="module")
def case():
    state = _build_reference_state(depth=DEPTH, width=WIDTH, style=STYLE, size=SIZE,
                                   in_res=RES)
    return dict(state=state, z=np.random.default_rng(21).standard_normal((2, STYLE)).astype(
        np.float32))


def _port_cams(cams):
    return CameraParams(*(torch.from_numpy(np.array(c)) for c in cams))


def _shifted_state(state, shift):
    state = dict(state)
    state["renderer.network.sigma_linear.bias"] = state[
        "renderer.network.sigma_linear.bias"] + np.float32(shift)
    return state


def _jax_probe_stats(params, rcfg, z, front):
    """The JAX probe CLI's statistics (``probe_geometry.py``), on its render."""
    style = j_gen.map_style(params, jnp.asarray(z))
    out = j_rend.render(params["renderer"], rcfg, front.focal, front.extrinsics, front.near,
                        front.far, style)
    s, mask = np.asarray(out.sdf), np.asarray(out.mask)
    beta = float(np.asarray(params["renderer"]["sigmoid_beta"]).ravel()[0])
    return dict(sdf_min=float(s.min()), sdf_max=float(s.max()),
                crossing=float(np.mean((s.min(axis=-2) < 0) & (s.max(axis=-2) > 0))),
                occupancy=float(np.mean(1.0 / (1.0 + np.exp(np.clip(s / beta, -30, 30))))),
                bg_mean=float(mask.mean()), bg_min=float(mask.min()),
                bg_max=float(mask.max()), beta=beta)


def _jax_verdict(st):
    if st["sdf_min"] > 0:
        return "BILLBOARD"
    if st["sdf_max"] < 0:
        return "FOG"
    return "WEAK" if st["crossing"] < 0.01 else "GEOMETRY"


@pytest.mark.parametrize("stage", ["a", "b"])
@pytest.mark.parametrize("shift", [0.0, 10.0, -10.0, "center"])
def test_probe_statistics_match_jax(case, stage, shift):
    """Same weights, z and frontal camera; ``shift`` moves the SDF head's
    bias to give each verdict (``center``: the median SDF at 0)."""
    res = 8
    stage_a = stage == "a"
    jcfg, pcfg = _configs(output_features=not stage_a)
    front = j_cams(res, None, batch=1, locations=jnp.zeros((1, 2)))
    z = case["z"][:1]
    state = case["state"]
    j_rcfg = replace(jcfg.renderer, out_im_res=res, n_samples=res, return_sdf=True,
                     return_xyz=True, perturb=0.0, static_viewdirs=True)
    if shift == "center":
        params = import_generator_state(state, renderer_type="sdf", depth=DEPTH)
        s = np.asarray(j_rend.render(params["renderer"], j_rcfg, front.focal, front.extrinsics,
                                     front.near, front.far,
                                     j_gen.map_style(params, jnp.asarray(z))).sdf)
        shift = -float(np.median(s))
    state = _shifted_state(state, shift)
    params = import_generator_state(state, renderer_type="sdf", depth=DEPTH)
    ref = _jax_probe_stats(params, j_rcfg, z, front)

    rcfg = probe_geometry.probe_renderer_config(pcfg.renderer, res)
    model = _port_model(state, pcfg)
    pack = None
    if not stage_a:  # the CLI's weight-sharing surface prober, fused field
        from sdface_gan_tpu_torch.ops.siren_kernel import pack_siren_field

        rcfg = replace(rcfg, use_fused_kernel=True)
        surf = Generator(replace(pcfg, full_pipeline=False, renderer=rcfg), device="cpu")
        copy_matching(surf, model.state_dict())
        model = surf.eval()
        pack = pack_siren_field(model.renderer.network)
    ours = probe_geometry.probe(model, rcfg, torch.from_numpy(z), _port_cams(front),
                                field_pack=pack, mesh=True)
    for k, v in ref.items():
        assert abs(ours[k] - v) <= STAT_TOL, (k, ours[k], v)
    assert probe_geometry.verdict(ours).split()[0] == _jax_verdict(ref)
    if shift == "center":
        assert _jax_verdict(ref) == "GEOMETRY" and ours["mesh_faces"] > 0


def test_probe_surface_matches_jax(case):
    """sdf_mesh's surface prober at a tiny resolution, truncated at 0.5."""
    res = 8
    state = _shifted_state(case["state"], 0.3)
    jcfg, pcfg = _configs()
    _, surf_cfg = sdf_mesh.mesh_configs(pcfg, res)
    model = _port_model(state, pcfg)
    surf = Generator(surf_cfg, device="cpu")
    copy_matching(surf, model.state_dict())
    from sdface_gan_tpu_torch.ops.siren_kernel import pack_siren_field

    trunc0 = np.random.default_rng(5).standard_normal((1, STYLE)).astype(np.float32) * 0.1
    front = j_cams(res, None, batch=1, locations=jnp.zeros((1, 2)))
    z = case["z"][1:]
    ours = sdf_mesh.probe_surface(surf.eval(), surf_cfg, torch.from_numpy(z), _port_cams(front),
                                  (torch.from_numpy(trunc0), None), 0.5,
                                  pack_siren_field(surf.renderer.network))
    params = import_generator_state(state, renderer_type="sdf", depth=DEPTH)
    j_rcfg = replace(jcfg.renderer, static_viewdirs=True, force_background=True, perturb=0.0,
                     out_im_res=res, n_samples=res, return_sdf=True, return_xyz=True)
    style = j_gen.map_style(params, jnp.asarray(z))
    style = trunc0 + 0.5 * (style - trunc0)
    ref = np.asarray(j_rend.render(params["renderer"], j_rcfg, front.focal, front.extrinsics,
                                   front.near, front.far, style).sdf)
    assert ours.shape == ref.shape == (1, res, res, res, 1)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=SDF_TOL)


def test_render_views_match_jax(case):
    """sdf_mesh's 8-view sweep (truncation 0.5, stored noise)."""
    state = case["state"]
    jcfg, pcfg = _configs()
    view_cfg, _ = sdf_mesh.mesh_configs(pcfg, 8)
    params = import_generator_state(state, renderer_type="sdf", depth=DEPTH)
    model = _port_model(state, pcfg)
    zs = np.random.default_rng(11).standard_normal((64, STYLE)).astype(np.float32)
    with torch.no_grad():
        trunc = _truncation_pair_port(model, zs)
    cams = j_cams(RES, jax.random.PRNGKey(3), batch=1, sweep=True)
    z8 = np.repeat(case["z"][:1], 8, axis=0)
    rgb, thumb = sdf_mesh.render_views(model, view_cfg, torch.from_numpy(z8), _port_cams(cams),
                                       trunc, 0.5)
    j_cfg = replace(jcfg, renderer=replace(jcfg.renderer, static_viewdirs=True,
                                           force_background=True, perturb=0.0))
    ref = j_gen.generator_forward(params, j_cfg, [jnp.asarray(z8)], cams.extrinsics, cams.focal,
                                  cams.near, cams.far, truncation=0.5,
                                  truncation_latent=_truncation_pair_jax(params, jcfg, zs),
                                  randomize_noise=False)
    assert rgb.shape == (8, SIZE, SIZE, 3)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(ref.rgb), **IMAGE_TOL)
    np.testing.assert_allclose(thumb.numpy(), np.asarray(ref.thumb_rgb), **IMAGE_TOL)


# ---------------------------------------------------------------- the CLIs

TINY = """inherit_from: configs/256res/ffhq_256_sdf.yaml
training:
  out_dir: out/tiny
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

def tiny_workspace(root):
    """A ``configs`` symlink, the tiny config ``tiny.yaml`` and seeded
    random-init stage A and stage B checkpoints under ``root/out/tiny``."""
    os.symlink(os.path.join(REPO, "configs"), root / "configs")
    (root / "tiny.yaml").write_text(TINY)
    cfg = load_config(str(root / "tiny.yaml"))
    for stage_a, sub, name in ((True, "out/tiny/volume_renderer", "vol_renderer"),
                               (False, "out/tiny", "full_pipeline")):
        gcfg = generator_config(stage_options(cfg, stage_a), stage_a=stage_a)
        g = Generator(gcfg, device="cpu", generator=torch.Generator().manual_seed(4))
        save_checkpoint(str(root / sub), name, {"g": g.state_dict(), "g_ema": g.state_dict()})
    return root


@pytest.fixture
def geo_ws(tmp_path, monkeypatch):
    monkeypatch.chdir(tiny_workspace(tmp_path))
    return tmp_path


@pytest.mark.parametrize("stage", ["a", "b"])
def test_probe_cli_prints_stats_and_a_verdict(geo_ws, capsys, stage):
    verdict = probe_geometry.main(["--config", "tiny.yaml", "--stage", stage, "--res", "8",
                                   "--identities", "2", "--mesh", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"verdict: {verdict}" in out and "beta 0.1000" in out
    assert "id1: sdf[" in out and "ray-crossing" in out and "occupancy" in out
    assert " mesh " in out


def test_sdf_mesh_cli_writes_views_and_meshes(geo_ws, capsys):
    meshes = sdf_mesh.main(["--config", "tiny.yaml", "--identities", "2", "--surface_res", "8",
                            "--device", "cpu"])
    out = capsys.readouterr().out
    renders = sorted(os.listdir(geo_ws / "out" / "tiny" / "renders"))
    assert len(renders) == 32 and "id001_view7_thumb.png" in renders
    assert set(meshes) == {0, 1}
    for ident, counts in meshes.items():
        if counts is None:
            assert f"id{ident}: marching cubes failed" in out
        else:
            assert (geo_ws / "out" / "tiny" / "meshes" / f"id{ident:03d}.obj").exists()
            assert f"id{ident}: {counts[0]} verts, {counts[1]} faces" in out
