"""The port's networks and whole generator against the JAX package.

One reference-layout state dict (``_build_reference_state``) feeds both
sides: JAX through ``import_generator_state``, the port through
``load_state_dict``.  Cameras are computed once and given to both; eval
mode (no jitter, stored decoder noise), at the shapes of
``test_full_chain_golden.py:40``.  Tolerances are those of that file.
"""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdface_gan_tpu.geometry import generate_camera_params as j_cams  # noqa: E402
from sdface_gan_tpu.models import generator as j_gen  # noqa: E402
from sdface_gan_tpu.models import renderer as j_rend  # noqa: E402
from sdface_gan_tpu.models import siren as j_siren  # noqa: E402
from sdface_gan_tpu.models import stylegan2 as j_sg  # noqa: E402
from sdface_gan_tpu.utils.torch_import import import_generator_state  # noqa: E402
from sdface_gan_tpu_torch.models import generator, renderer, stylegan2  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import jax_params_to_state_dict  # noqa: E402

from test_torch_import import _build_reference_state  # noqa: E402
from test_torch_port_training import _two_threads  # noqa: E402,F401  (autouse: two threads)

DEPTH, WIDTH, STYLE, SIZE, RES, SAMPLES = 2, 32, 16, 32, 16, 6
THUMB_TOL = dict(rtol=1e-4, atol=2e-5)
IMAGE_TOL = dict(rtol=2e-3, atol=2e-4)


def _configs(**renderer_kw):
    rkw = dict(type="sdf", out_im_res=RES, n_samples=SAMPLES, style_dim=STYLE,
               width=WIDTH, depth=DEPTH, **renderer_kw)
    jcfg = j_gen.GeneratorConfig(size=SIZE, style_dim=STYLE, full_pipeline=True,
                                 channel_multiplier=1,
                                 renderer=j_rend.RendererConfig(**rkw))
    pcfg = generator.GeneratorConfig(size=SIZE, style_dim=STYLE, full_pipeline=True,
                                     channel_multiplier=1,
                                     renderer=renderer.RendererConfig(**rkw))
    return jcfg, pcfg


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_model(state, pcfg):
    model = generator.Generator(pcfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return model.eval()


@pytest.fixture(scope="module")
def case():
    state = _build_reference_state(depth=DEPTH, width=WIDTH, style=STYLE, size=SIZE,
                                   in_res=RES)
    params = import_generator_state(state, renderer_type="sdf", depth=DEPTH)
    jcfg, pcfg = _configs()
    cams = j_cams(RES, jax.random.PRNGKey(7), batch=2)
    z = np.random.default_rng(3).standard_normal((2, STYLE)).astype(np.float32)
    return dict(state=state, params=params, jcfg=jcfg, pcfg=pcfg, cams=cams, z=z,
                model=_port_model(state, pcfg))


def _cam_args(cams):
    return [_t(c) for c in (cams.extrinsics, cams.focal, cams.near, cams.far)]


def test_siren_module_matches_jax(case):
    rng = np.random.default_rng(4)
    pts = (rng.standard_normal((2, 50, 3)) * 0.5).astype(np.float32)
    views = rng.standard_normal((2, 50, 3)).astype(np.float32)
    style = rng.standard_normal((2, STYLE)).astype(np.float32)
    net_p = case["params"]["renderer"]["network"]
    ref = j_siren.apply_siren_generator(net_p, case["jcfg"].renderer.network_config(),
                                        pts, views, style)
    with torch.no_grad():
        ours = case["model"].renderer.network(_t(pts), _t(views), _t(style))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **THUMB_TOL)


@pytest.mark.parametrize("bg_mode,with_sdf", [
    ("lastsample", True), ("white", True), ("lastsample", False)])
def test_render_matches_jax(case, bg_mode, with_sdf):
    jcfg, pcfg = _configs(bg_mode=bg_mode, with_sdf=with_sdf, return_sdf=True,
                          return_xyz=True)
    cams = case["cams"]
    style = np.random.default_rng(5).standard_normal((2, STYLE)).astype(np.float32)
    ref = j_rend.render(case["params"]["renderer"], jcfg.renderer, cams.focal,
                        cams.extrinsics, cams.near, cams.far, jnp.asarray(style))
    extr, focal, near, far = _cam_args(cams)
    with torch.no_grad():
        ours = renderer.render(case["model"].renderer, pcfg.renderer, focal, extr, near,
                               far, _t(style))
    for name in ("rgb", "features", "sdf", "xyz", "mask"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)), **THUMB_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("which", ["plain", "up", "to_rgb"])
def test_modulated_conv_matches_jax(case, which):
    dec_p, dcfg = case["params"]["decoder"], case["jcfg"].decoder
    rng = np.random.default_rng(6)
    if which == "plain":
        mp, mod = dec_p["conv1"]["conv"], case["model"].decoder.conv1.conv
        mcfg = j_sg.ModConvConfig(WIDTH, dcfg.channels[RES], 3, dcfg.style_dim)
    elif which == "up":
        mp, mod = dec_p["convs"][0]["conv"], case["model"].decoder.convs[0].conv
        mcfg = j_sg.ModConvConfig(dcfg.channels[RES], dcfg.channels[2 * RES], 3,
                                  dcfg.style_dim, upsample=True)
    else:
        mp, mod = dec_p["to_rgb1"]["conv"], case["model"].decoder.to_rgb1.conv
        mcfg = j_sg.ModConvConfig(dcfg.channels[RES], 3, 1, dcfg.style_dim, demodulate=False)
    x = rng.standard_normal((2, 8, 8, mcfg.in_ch)).astype(np.float32)
    style = rng.standard_normal((2, dcfg.style_dim)).astype(np.float32)
    ref = np.asarray(j_sg.apply_modulated_conv(mp, mcfg, jnp.asarray(x), jnp.asarray(style)))
    with torch.no_grad():
        ours = mod(_t(x).permute(0, 3, 1, 2), _t(style)).permute(0, 2, 3, 1).numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, **IMAGE_TOL)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0)])
def test_equal_conv2d_matches_jax(stride, padding):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 9, 5)).astype(np.float32)
    conv = stylegan2.EqualConv2d(5, 7, 3, stride=stride, padding=padding,
                                 generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        conv.bias.copy_(torch.from_numpy(rng.standard_normal(7).astype(np.float32)))
        ours = conv(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    p = {"w": jnp.asarray(conv.weight.detach().numpy().transpose(2, 3, 1, 0)),
         "b": jnp.asarray(conv.bias.detach().numpy())}
    ref = np.asarray(j_sg.apply_equal_conv2d(p, jnp.asarray(x), stride=stride,
                                             padding=padding))
    np.testing.assert_allclose(ours, ref, **IMAGE_TOL)


def test_decoder_matches_jax(case):
    dcfg = case["jcfg"].decoder
    rng = np.random.default_rng(7)
    feat = rng.standard_normal((2, RES, RES, WIDTH)).astype(np.float32)
    latent = rng.standard_normal((2, dcfg.n_latent, dcfg.style_dim)).astype(np.float32)
    ref = j_sg.apply_decoder(case["params"]["decoder"], dcfg, jnp.asarray(feat),
                             jnp.asarray(latent))
    with torch.no_grad():
        ours = stylegan2.apply_decoder(case["model"].decoder, case["pcfg"].decoder,
                                       _t(feat), _t(latent))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **IMAGE_TOL)


def _truncation_pair_jax(params, jcfg, zs):
    r_lat = j_gen.map_style(params, jnp.asarray(zs))
    return (jnp.mean(r_lat, 0, keepdims=True),
            j_sg.decoder_mean_latent(params["decoder"], jcfg.decoder, r_lat))


def _truncation_pair_port(model, zs):
    r_lat = generator.map_style(model, _t(zs))
    return (r_lat.mean(0, keepdim=True),
            stylegan2.decoder_mean_latent(model.decoder, r_lat))


@pytest.mark.parametrize(
    "mode", ["plain", "truncation", "mixing", "fused_field", "explicit_noise_and_latent"])
def test_generator_forward_matches_jax(case, mode):
    params, jcfg, pcfg, cams, z = (case[k] for k in ("params", "jcfg", "pcfg", "cams", "z"))
    kw_j, kw_p = {}, {}
    styles = [z]
    if mode == "truncation":
        zs = np.random.default_rng(11).standard_normal((64, STYLE)).astype(np.float32)
        kw_j = dict(truncation=0.7, truncation_latent=_truncation_pair_jax(params, jcfg, zs))
        with torch.no_grad():
            kw_p = dict(truncation=0.7, truncation_latent=_truncation_pair_port(case["model"], zs))
    elif mode == "mixing":
        styles = [z, np.random.default_rng(12).standard_normal((2, STYLE)).astype(np.float32)]
        kw_j = kw_p = dict(inject_index=2)
    elif mode == "explicit_noise_and_latent":
        rng = np.random.default_rng(13)
        noise = [rng.standard_normal((2, r, r)).astype(np.float32)
                 for r in jcfg.decoder.noise_shapes()]
        rlat = rng.standard_normal((2, STYLE)).astype(np.float32)
        kw_j = dict(decoder_noise=[jnp.asarray(n[..., None]) for n in noise],
                    renderer_latent=jnp.asarray(rlat))
        kw_p = dict(decoder_noise=[_t(n[:, None]) for n in noise], renderer_latent=_t(rlat))
    elif mode == "fused_field":
        # the port's fused-field dispatch (its plain version on the CPU, f32)
        pcfg = replace(pcfg, renderer=replace(pcfg.renderer, use_fused_kernel=True))
    ref = j_gen.generator_forward(params, jcfg, [jnp.asarray(s) for s in styles],
                                  cams.extrinsics, cams.focal, cams.near, cams.far,
                                  key=None, randomize_noise=False, **kw_j)
    with torch.no_grad():
        ours = generator.generator_forward(case["model"], pcfg, [_t(s) for s in styles],
                                           *_cam_args(cams), randomize_noise=False, **kw_p)
    assert ours.rgb.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(ours.thumb_rgb.numpy(), np.asarray(ref.thumb_rgb), **THUMB_TOL)
    np.testing.assert_allclose(ours.rgb.numpy(), np.asarray(ref.rgb), **IMAGE_TOL)


@pytest.mark.parametrize("field", ["plain", "fused_field"])
def test_bf16_generator_quality_matches_jax(case, field):
    """bf16 weights end to end: the port's image error against the f32
    truth is no worse than the JAX bf16 path's (the rule of
    test_ops.py:346-381, applied to the whole generator), and not zero
    (the bf16 path really rounds)."""
    params, jcfg, pcfg, cams, z = (case[k] for k in ("params", "jcfg", "pcfg", "cams", "z"))
    args_j = ([jnp.asarray(z)], cams.extrinsics, cams.focal, cams.near, cams.far)
    truth = np.asarray(j_gen.generator_forward(params, jcfg, *args_j, key=None,
                                               randomize_noise=False).rgb)
    p16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), params)
    jax16 = np.asarray(j_gen.generator_forward(p16, jcfg, *args_j, key=None,
                                               randomize_noise=False).rgb)
    pcfg = replace(pcfg, renderer=replace(pcfg.renderer,
                                          use_fused_kernel=field == "fused_field"))
    model16 = _port_model(case["state"], pcfg).to(torch.bfloat16)
    with torch.no_grad():
        ours = generator.generator_forward(model16, pcfg, [_t(z)], *_cam_args(cams),
                                           randomize_noise=False).rgb
    assert ours.dtype == torch.bfloat16
    err_jax = np.mean(np.abs(jax16.astype(np.float32) - truth))
    err_ours = np.mean(np.abs(ours.float().numpy() - truth))
    assert 0.1 * err_jax < err_ours <= 1.2 * err_jax, (err_ours, err_jax)


def test_converter_round_trip_is_exact(case):
    state = case["state"]
    back = jax_params_to_state_dict(case["params"], case["pcfg"])
    assert set(back) == set(state)
    for k, v in state.items():
        assert back[k].dtype == torch.float32 and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_model_loaded_through_converter_is_identical(case):
    model = generator.Generator(case["pcfg"], device="cpu")
    model.load_state_dict(jax_params_to_state_dict(case["params"], case["pcfg"]))
    args = ([_t(case["z"])], *_cam_args(case["cams"]))
    with torch.no_grad():
        a = generator.generator_forward(model, case["pcfg"], *args, randomize_noise=False)
        b = generator.generator_forward(case["model"], case["pcfg"], *args,
                                        randomize_noise=False)
    assert torch.equal(a.rgb, b.rgb) and torch.equal(a.thumb_rgb, b.thumb_rgb)


def test_init_matches_jax_distributions():
    """The port's initializers draw from the JAX package's distributions:
    same keys and shapes, constants equal, spreads and means alike."""
    _, pcfg = _configs()
    jcfg = j_gen.GeneratorConfig(size=SIZE, style_dim=STYLE, channel_multiplier=1,
                                 renderer=j_rend.RendererConfig(
                                     out_im_res=RES, n_samples=SAMPLES, style_dim=STYLE,
                                     width=WIDTH, depth=DEPTH))
    ref = jax_params_to_state_dict(j_gen.init_generator(jax.random.PRNGKey(0), jcfg), pcfg)
    ours = generator.Generator(pcfg, device="cpu",
                               generator=torch.Generator().manual_seed(1)).state_dict()
    assert set(ours) == set(ref)
    for k, r in ref.items():
        o = ours[k]
        assert o.shape == r.shape, k
        constant = k.endswith(("sigmoid_beta", "noise.weight")) or (
            r.numel() > 1 and r.std() == 0)
        if constant:
            assert torch.equal(o, r), k
        elif r.numel() >= 1000:
            assert abs(o.std() - r.std()) <= 0.1 * r.std(), k
            assert abs(o.mean() - r.mean()) <= 0.15 * r.std(), k
            assert o.abs().max() <= 6 * r.std() + r.abs().max(), k

    # the NGP hash table: U(-1e-4, 1e-4) on both sides
    rkw = dict(type="ngp", out_im_res=RES, n_samples=SAMPLES, style_dim=STYLE, width=STYLE,
               ngp_num_levels=3, ngp_level_dim=2, ngp_finest_res=64, ngp_log2_hashmap_size=12)
    ngp_j = j_rend.init_renderer(jax.random.PRNGKey(0), j_rend.RendererConfig(**rkw))
    ref = torch.from_numpy(np.array(ngp_j["network"]["hash_table"]))
    ours = renderer.VolumeFeatureRenderer(renderer.RendererConfig(**rkw),
                                          generator=torch.Generator().manual_seed(1)
                                          ).network.encoder.embeddings.detach()
    assert ours.shape == ref.shape and ref.numel() >= 1000
    assert abs(ours.std() - ref.std()) <= 0.1 * ref.std()
    assert abs(ours.mean() - ref.mean()) <= 0.15 * ref.std()
    assert ours.abs().max() <= 1e-4 and ref.abs().max() <= 1e-4
