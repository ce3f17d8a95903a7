"""The port's NGP and FC fields, renderer paths and generators against the
JAX package, the hand-built yaml configurations, and the CPU sampler.

The weights are the JAX package's own init (``init_generator``) with the
NGP hash table redrawn from numpy with std 1, so that the encode shows in
the image (the init's U(-1e-4, 1e-4) table would hide it); the port loads
them through ``jax_params_to_state_dict``, whose round trip back through
``import_generator_state`` is checked bit for bit here.  Eval mode as in
``test_torch_port_models.py``: fixed cameras, ``key=None``,
``randomize_noise=False``, and its tolerances.
"""

from dataclasses import fields
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdface_gan_tpu.config import load_config  # noqa: E402
from sdface_gan_tpu.config.build import generator_config  # noqa: E402
from sdface_gan_tpu.config.sdf_options import (  # noqa: E402
    get_vol_render_opt,
    rendering_overrides,
    resolve_renderer_type,
)
from sdface_gan_tpu.config.yaml_config import default_config_path  # noqa: E402
from sdface_gan_tpu.geometry import generate_camera_params as j_cams  # noqa: E402
from sdface_gan_tpu.models import generator as j_gen  # noqa: E402
from sdface_gan_tpu.models import renderer as j_rend  # noqa: E402
from sdface_gan_tpu.models import siren as j_siren  # noqa: E402
from sdface_gan_tpu.utils.torch_import import import_generator_state  # noqa: E402
from sdface_gan_tpu_torch import configs  # noqa: E402
from sdface_gan_tpu_torch.models import generator, renderer  # noqa: E402
from sdface_gan_tpu_torch.ops import _ext  # noqa: E402
from sdface_gan_tpu_torch.serving import SDFaceSampler  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import jax_params_to_state_dict  # noqa: E402

from test_torch_port_models import IMAGE_TOL, THUMB_TOL  # noqa: E402
from test_torch_port_training import _two_threads  # noqa: E402,F401  (autouse: two threads)

SIZE, RES, SAMPLES = 32, 16, 6
CONFIGS = Path(__file__).resolve().parents[1] / "configs" / "256res"
# NGP features are style_dim wide and the decoder takes renderer.width
# channels (JAX GeneratorConfig.decoder), so the NGP cases use width = style.
# The renderer fixes the base resolution at 16, so T = 2^13 is the smallest
# table that keeps level 0 dense (17^3 rows); levels 1-3 hash.
NGP = dict(type="ngp", style_dim=16, width=16, depth=2, ngp_num_levels=4, ngp_level_dim=2,
           ngp_finest_res=64, ngp_log2_hashmap_size=13)
FC = dict(type="fc", style_dim=16, width=32, depth=2)
PACK_MB = {"unpacked": 0, "packed": 1}  # 1 MB packs levels 0 and 1: a partial pack


def _configs(field, **kw):
    rkw = dict(out_im_res=RES, n_samples=SAMPLES, **(NGP if field == "ngp" else FC), **kw)
    style = rkw["style_dim"]
    jcfg = j_gen.GeneratorConfig(size=SIZE, style_dim=style, channel_multiplier=1,
                                 renderer=j_rend.RendererConfig(**rkw))
    pcfg = generator.GeneratorConfig(size=SIZE, style_dim=style, channel_multiplier=1,
                                     renderer=renderer.RendererConfig(**rkw))
    return jcfg, pcfg


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_params(field, jcfg):
    params = j_gen.init_generator(jax.random.PRNGKey(3), jcfg)
    if field == "ngp":
        net = params["renderer"]["network"]
        rng = np.random.default_rng(9)
        net["hash_table"] = jnp.asarray(
            rng.standard_normal(net["hash_table"].shape).astype(np.float32))
    return params


def _port_model(params, pcfg):
    model = generator.Generator(pcfg, device="cpu")
    model.load_state_dict(jax_params_to_state_dict(params, pcfg))
    return model.eval()


def _case(field):
    jcfg, pcfg = _configs(field)
    params = _jax_params(field, jcfg)
    cams = j_cams(RES, jax.random.PRNGKey(7), batch=2)
    z = np.random.default_rng(3).standard_normal((2, jcfg.style_dim)).astype(np.float32)
    return dict(field=field, params=params, jcfg=jcfg, pcfg=pcfg, cams=cams, z=z,
                model=_port_model(params, pcfg))


@pytest.fixture(scope="module", params=["ngp", "fc"])
def case(request):
    return _case(request.param)


def _cam_args(cams):
    return [_t(c) for c in (cams.extrinsics, cams.focal, cams.near, cams.far)]


def test_field_module_matches_jax(case):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-2.2, 2.2, (2, 60, 3)).astype(np.float32)  # some outside the box
    views = rng.standard_normal((2, 60, 3)).astype(np.float32)
    views /= np.linalg.norm(views, axis=-1, keepdims=True)
    style = rng.standard_normal((2, case["jcfg"].style_dim)).astype(np.float32)
    net_p = case["params"]["renderer"]["network"]
    net_cfg = case["jcfg"].renderer.network_config()
    apply = (j_siren.apply_ngp_siren_generator if case["field"] == "ngp"
             else j_siren.apply_fc_generator)
    ref = np.asarray(apply(net_p, net_cfg, pts, views, style))
    with torch.no_grad():
        ours = case["model"].renderer.network(_t(pts), _t(views), _t(style))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, **THUMB_TOL)


@pytest.mark.parametrize("pack", list(PACK_MB))
@pytest.mark.parametrize("kernels", [False, True])
def test_ngp_generator_forward_matches_jax(pack, kernels):
    """Packed and unpacked, through the plain path and the kernel path (its
    plain versions on the CPU); the JAX side packs as its sampler does."""
    jcfg, pcfg = _configs("ngp", ngp_pack_mb=PACK_MB[pack], use_fused_kernel=kernels)
    params = _jax_params("ngp", jcfg)
    model = _port_model(params, pcfg)
    if pack == "packed":
        plan = pcfg.renderer.network_config().pack_plan
        assert plan.packed_levels == (0, 1)
        spec = plan.spec
        assert [spec.level_uses_hash(lvl) for lvl in range(4)] == [False, True, True, True]
        params = j_gen.pack_generator_for_inference(params, jcfg)
        generator.pack_generator_for_inference(model)
        assert model.renderer.network.encoder.packed is not None
        assert "renderer.network.encoder.packed" not in model.state_dict()
    cams = j_cams(RES, jax.random.PRNGKey(8), batch=2)
    z = np.random.default_rng(5).standard_normal((2, 16)).astype(np.float32)
    ref = j_gen.generator_forward(params, jcfg, [jnp.asarray(z)], cams.extrinsics, cams.focal,
                                  cams.near, cams.far, key=None, randomize_noise=False)
    before = dict(_ext.LAUNCHES)
    with torch.no_grad():
        ours = generator.generator_forward(model, pcfg, [_t(z)], *_cam_args(cams),
                                           randomize_noise=False)
    assert _ext.LAUNCHES == before  # CPU tensors: plain versions only
    assert ours.rgb.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(ours.thumb_rgb.numpy(), np.asarray(ref.thumb_rgb), **THUMB_TOL)
    np.testing.assert_allclose(ours.rgb.numpy(), np.asarray(ref.rgb), **IMAGE_TOL)


def test_fc_generator_forward_matches_jax():
    case = _case("fc")
    params, jcfg, pcfg, cams, z = (case[k] for k in ("params", "jcfg", "pcfg", "cams", "z"))
    ref = j_gen.generator_forward(params, jcfg, [jnp.asarray(z)], cams.extrinsics, cams.focal,
                                  cams.near, cams.far, key=None, randomize_noise=False)
    with torch.no_grad():
        ours = generator.generator_forward(case["model"], pcfg, [_t(z)], *_cam_args(cams),
                                           randomize_noise=False)
    np.testing.assert_allclose(ours.thumb_rgb.numpy(), np.asarray(ref.thumb_rgb), **THUMB_TOL)
    np.testing.assert_allclose(ours.rgb.numpy(), np.asarray(ref.rgb), **IMAGE_TOL)


@pytest.mark.parametrize("pack", list(PACK_MB))
def test_bf16_ngp_generator_quality_matches_jax(pack):
    """bf16 weights (hash table and packed table included): the port's image
    error against the f32 truth is at most 1.2x the JAX bf16 path's + 1e-4."""
    jcfg, pcfg = _configs("ngp", ngp_pack_mb=PACK_MB[pack], use_fused_kernel=True)
    params = _jax_params("ngp", jcfg)
    cams = j_cams(RES, jax.random.PRNGKey(8), batch=2)
    z = np.random.default_rng(6).standard_normal((2, 16)).astype(np.float32)
    args_j = ([jnp.asarray(z)], cams.extrinsics, cams.focal, cams.near, cams.far)
    truth = np.asarray(j_gen.generator_forward(params, jcfg, *args_j, key=None,
                                               randomize_noise=False).rgb)
    p16 = j_gen.pack_generator_for_inference(
        jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), params), jcfg)
    jax16 = np.asarray(j_gen.generator_forward(p16, jcfg, *args_j, key=None,
                                               randomize_noise=False).rgb)
    model16 = generator.pack_generator_for_inference(
        _port_model(params, pcfg).to(torch.bfloat16))
    with torch.no_grad():
        ours = generator.generator_forward(model16, pcfg, [_t(z)], *_cam_args(cams),
                                           randomize_noise=False).rgb
    assert ours.dtype == torch.bfloat16
    err_jax = np.mean(np.abs(jax16.astype(np.float32) - truth))
    err_ours = np.mean(np.abs(ours.float().numpy() - truth))
    assert 0 < err_ours <= 1.2 * err_jax + 1e-4, (err_ours, err_jax)


def test_converter_round_trip_is_exact(case):
    """JAX tree -> port state dict -> ``import_generator_state`` -> the same
    JAX tree, bit for bit; and the state dict loads strictly."""
    params, pcfg = case["params"], case["pcfg"]
    state = jax_params_to_state_dict(params, pcfg)
    back = import_generator_state({k: v.numpy() for k, v in state.items()},
                                  renderer_type=case["field"], depth=pcfg.renderer.depth)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))
    model = generator.Generator(pcfg, device="cpu")
    assert set(model.state_dict()) == set(state)
    model.load_state_dict(state)


@pytest.mark.parametrize("name,ngp_flag", [
    ("ffhq_256_sdf_ngp_tpu", False), ("ffhq_256_sdf_ngp", True)])
def test_hand_built_configs_match_the_yaml(name, ngp_flag):
    """Resolved as ``train.py`` resolves a config for stage B; the upstream
    file selects NGP through ``--ngp 1``."""
    cfg = load_config(str(CONFIGS / f"{name}.yaml"), default_config_path())
    opt = get_vol_render_opt(cfg["training"]["out_dir"].split("/")[1], False,
                             ngp=resolve_renderer_type(cfg, ngp_flag),
                             size=cfg["data"].get("img_size", 256),
                             extra_argv=rendering_overrides(cfg))
    ref = generator_config(opt, stage_a=False)
    ours = getattr(configs, name)()
    for f in fields(ours):
        if f.name != "renderer":
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    for f in fields(ours.renderer):
        assert getattr(ours.renderer, f.name) == getattr(ref.renderer, f.name), f.name
    jnet, pnet = ref.renderer.network_config(), ours.renderer.network_config()
    assert pnet.grid.offsets == jnet.grid.offsets and pnet.width == jnet.width
    jplan, pplan = jnet.pack_plan, pnet.pack_plan
    assert (pplan is None) == (jplan is None)
    if pplan is not None:
        assert pplan.packed_levels == jplan.packed_levels == (0, 1)
        assert pplan.row_offsets == jplan.row_offsets


@pytest.mark.parametrize("pack", list(PACK_MB))
def test_cpu_sampler_serves_ngp(pack):
    jcfg, pcfg = _configs("ngp", ngp_pack_mb=PACK_MB[pack])
    model = _port_model(_jax_params("ngp", jcfg), pcfg)
    before = dict(_ext.LAUNCHES)
    sampler = SDFaceSampler(model, batch=2)
    assert sampler.cfg.renderer.use_fused_kernel and sampler._field_pack is None
    assert (model.renderer.network.encoder.packed is not None) == (pack == "packed")
    img = sampler.sample(seed=4)
    assert img.shape == (2, SIZE, SIZE, 3) and bool(torch.isfinite(img).all())
    assert torch.equal(img, sampler.sample(seed=4))
    plain = SDFaceSampler(model, batch=2, use_fused_kernel=False).sample(seed=4)
    np.testing.assert_allclose(img.numpy(), plain.numpy(), **IMAGE_TOL)
    assert _ext.LAUNCHES == before
    angles = sampler.sample(azim=0.1, elev=0.05)
    assert bool(torch.isfinite(angles).all())


def test_ngp_field_honours_remat():
    """A grad-on NGP render (the stage-A renderer: SDF returned, no
    features) with ``remat`` on recomputes the field in the backward pass:
    fewer tensors saved for it than with ``remat`` off, with equal values
    and the same gradients of every renderer parameter, as
    ``jax.checkpoint`` wraps every field type in the JAX package.  The
    table's gradient is a scatter-add whose summation order may differ
    between the two backward passes (and with the thread count): rtol 1e-5,
    atol 1e-6 of the tensor's largest entry (a few f32 ulps of it)."""
    from dataclasses import replace

    jcfg, pcfg = _configs("ngp", output_features=False, return_sdf=True)
    params = _jax_params("ngp", jcfg)
    extrinsics, focal, near, far = _cam_args(j_cams(RES, jax.random.PRNGKey(9), batch=2))
    style = _t(np.random.default_rng(6).standard_normal((2, 16)).astype(np.float32))
    runs = {}
    for remat in (True, False):
        cfg = replace(pcfg, renderer=replace(pcfg.renderer, remat=remat))
        model = _port_model(params, cfg)
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            out = renderer.render(model.renderer, cfg.renderer, focal, extrinsics, near, far,
                                  style)
        loss = out.rgb.square().sum() + out.sdf.square().sum()
        names, ps = zip(*model.renderer.named_parameters())
        runs[remat] = (len(saved), out, dict(zip(names, torch.autograd.grad(loss, ps))))
    (n_remat, out_remat, g_remat), (n_plain, out_plain, g_plain) = runs[True], runs[False]
    assert n_remat < n_plain
    assert torch.equal(out_remat.rgb, out_plain.rgb) and torch.equal(out_remat.sdf, out_plain.sdf)
    assert set(g_remat) == set(g_plain) and "network.encoder.embeddings" in g_remat
    for name in g_remat:
        scale = g_plain[name].abs().max().item()
        torch.testing.assert_close(g_remat[name], g_plain[name], rtol=1e-5,
                                   atol=1e-6 * scale, msg=name)
