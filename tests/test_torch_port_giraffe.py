"""The GIRAFFE family's serving path on the CPU, the port against
``sdface_gan_tpu/giraffe/`` in f32, same weights and inputs:

* camera and box functions, and each sampler's map on JAX's own draws
  (the ``jax.random`` calls repeated): <= 1e-6 abs; ``torch.linspace``
  within 2.4e-7 of ``jnp.linspace``;
* the decoders in every encoding (NeRF positional, Gauss, hash with
  out-of-box points), with and without view directions, skips, the small
  decoder: <= 1e-5 of the output's max; ``n_blocks_view > 1`` fails in both;
* the neural renderer (nn and bilinear + blur, with and without the RGB
  skip, with ``conv_in``); ``giraffe_forward`` in eval mode (1, 2 and 3
  boxes, sum and max composition, object masks, only / not the
  background, alpha maps, no neural renderer) and in training mode with
  JAX's depth jitter and density noise injected: ``IMAGE_TOL``;
* ``giraffe_config_from_yaml`` on every GIRAFFE yaml x the model flags;
* every render program's frames on JAX's draws (the port's samplers
  patched), the PNG sheet's pixels, ``extract_giraffe_mesh``'s alpha
  volume (<= 1e-5) and face count;
* ``ImagesDataset`` / ``ImagesLoader`` equal to JAX's (PIL's) arrays;
* full width (``ffhq_256``, plain and hash decoders at T = 2^19) at batch
  1, and a flagship-width ``model`` tree through JAX's ``CheckpointIO``,
  export and import, bit-exact;
* the committed JAX run (``tests/fixtures/jax_giraffe_run/``): JAX's
  forward of its archives reproduces its stored images; imported, the
  port renders them within ``IMAGE_TOL``; ``render`` (``--vae 1``,
  ``--export_meshes 1``) and ``extract_mesh`` run from it on the CPU;
* refusals, and the JAX ``render.py``'s template (no model flags).
"""

import dataclasses
import functools
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdface_gan_tpu.config import load_config as j_load_config  # noqa: E402
from sdface_gan_tpu.config.yaml_config import default_config_path  # noqa: E402
from sdface_gan_tpu.data import images as j_images  # noqa: E402
from sdface_gan_tpu.encoder import vae as j_vae  # noqa: E402
from sdface_gan_tpu.giraffe import bbox as j_bbox  # noqa: E402
from sdface_gan_tpu.giraffe import camera as j_cam  # noqa: E402
from sdface_gan_tpu.giraffe import config as j_config  # noqa: E402
from sdface_gan_tpu.giraffe import decoder as j_dec  # noqa: E402
from sdface_gan_tpu.giraffe import discriminator as j_disc  # noqa: E402
from sdface_gan_tpu.giraffe import generator as j_gen  # noqa: E402
from sdface_gan_tpu.giraffe import neural_renderer as j_nr  # noqa: E402
from sdface_gan_tpu.giraffe import rendering as j_rend  # noqa: E402
from sdface_gan_tpu.giraffe import trainer as j_trainer  # noqa: E402
from sdface_gan_tpu.utils import checkpoints as j_ckpt  # noqa: E402
from sdface_gan_tpu_torch import extract_mesh as p_extract_cli  # noqa: E402
from sdface_gan_tpu_torch import import_jax_checkpoints as import_cli  # noqa: E402
from sdface_gan_tpu_torch import render as p_render_cli  # noqa: E402
from sdface_gan_tpu_torch.config import load_config  # noqa: E402
from sdface_gan_tpu_torch.config.yaml_config import default_config_path as p_default  # noqa: E402
from sdface_gan_tpu_torch.data import images as p_images  # noqa: E402
from sdface_gan_tpu_torch.encoder.vae import VAEEncoder, VAEEncoderConfig  # noqa: E402
from sdface_gan_tpu_torch.giraffe import bbox as p_bbox  # noqa: E402
from sdface_gan_tpu_torch.giraffe import camera as p_cam  # noqa: E402
from sdface_gan_tpu_torch.giraffe import config as p_config  # noqa: E402
from sdface_gan_tpu_torch.giraffe import decoder as p_dec  # noqa: E402
from sdface_gan_tpu_torch.giraffe import generator as p_gen  # noqa: E402
from sdface_gan_tpu_torch.giraffe import neural_renderer as p_nr  # noqa: E402
from sdface_gan_tpu_torch.giraffe import rendering as p_rend  # noqa: E402
from sdface_gan_tpu_torch.utils import checkpoints  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import (  # noqa: E402
    jax_giraffe_params_to_state_dict,
    jax_vae_params_to_state_dict,
)
from sdface_gan_tpu_torch.utils.jax_export import read_export  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
from export_jax_checkpoint import export_run  # noqa: E402

from test_torch_port_models import IMAGE_TOL  # noqa: E402

FIXTURE = REPO / "tests" / "fixtures" / "jax_giraffe_run"
IMAGES = REPO / "tests" / "fixtures" / "images"
FIXTURE_FLAGS = ["--sdf", "0", "--i_embed", "1", "--log2_hashmap_size", "10",
                 "--finest_res", "64"]
Z, ZB, FEAT, RES, STEPS = 8, 4, 8, 8, 6
CAM_TOL = 1e-6

# JAX's forward and init, compiled (eagerly JAX compiles every op apart)
_STATIC = ("cfg", "mode", "batch_size", "not_render_background", "only_render_background",
           "return_alpha_map")
j_forward = jax.jit(j_gen.giraffe_forward, static_argnames=_STATIC)
j_init = jax.jit(j_gen.init_giraffe, static_argnums=1)


def T(x):
    return torch.from_numpy(np.array(x))


def _codes(codes):
    return p_gen.LatentCodes(*map(T, codes))


def _cfgs(n_boxes=1, enc="normal", small=False, maxc=False, nr=True, bbox=None, **nr_kw):
    """(JAX, port) GiraffeConfigs of the same small model: FFHQ's scene (box
    scale 0.21, fov 10, so most hash inputs are out of the box), an 8^2
    volume of 6 samples, a 16^2 image."""
    bbox = dict(dict(scale_range_min=(0.21,) * 3, scale_range_max=(0.3,) * 3,
                     translation_range_min=(-0.3, -0.3, 0.0),
                     translation_range_max=(0.3, 0.3, 0.0),
                     rotation_range=(0.40278, 0.59722)), **(bbox or {}))

    def build(gen, dec, bb, nrm):
        spec = dec.giraffe_hash_spec(64, 10)
        return gen.GiraffeConfig(
            z_dim=Z, z_dim_bg=ZB, n_ray_samples=STEPS, resolution_vol=RES, fov=10.0,
            range_v=(0.4167, 0.5), use_max_composition=maxc, small_decoder=small,
            decoder=dec.DecoderConfig(z_dim=Z, hidden_size=16, n_blocks=4, skips=(2,),
                                      rgb_out_dim=FEAT, positional_encoding=enc,
                                      hash_spec=spec if enc == "hash" else None),
            small=dec.SmallDecoderConfig(z_dim=Z, rgb_out_dim=FEAT, hidden_size=16,
                                         hash_spec=spec),
            background=dec.DecoderConfig(z_dim=ZB, hidden_size=16, n_blocks=2, skips=(),
                                         downscale_p_by=12.0, rgb_out_dim=FEAT),
            bbox=bb.BBoxConfig(n_boxes=n_boxes, **bbox),
            neural_renderer=(nrm.NeuralRendererConfig(**dict(dict(
                n_feat=FEAT, input_dim=FEAT, img_size=32, min_feat=4), **nr_kw)) if nr else None))

    return build(j_gen, j_dec, j_bbox, j_nr), build(p_gen, p_dec, p_bbox, p_nr)


def _jax_tree(sd):
    """A port state dict as the JAX parameter tree (the converter's inverse:
    ``weight`` [out, in] -> ``w`` [in, out], OIHW -> HWIO, ``.{i}`` -> lists)."""
    tree = {}
    for key, v in sd.items():
        *parents, leaf = key.split(".")
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        v = v.numpy()
        if leaf == "weight":
            node["w"] = v.T if v.ndim == 2 else v.transpose(2, 3, 1, 0)
        else:
            node["b" if leaf == "bias" else leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(tree)


@functools.lru_cache(maxsize=None)
def _models(jcfg, pcfg, seed=0):
    """The port's generator drawn from ``seed`` (the hash table redrawn with
    std 1, so that the encode matters) and the same weights as JAX's tree
    (one pair per config: the tests only read them)."""
    g = p_gen.GiraffeGenerator(pcfg, torch.Generator().manual_seed(seed))
    if hasattr(g.decoder, "hash_table"):
        with torch.no_grad():
            g.decoder.hash_table.normal_(generator=torch.Generator().manual_seed(seed))
    return _jax_tree(g.state_dict()), g.eval()


def _scene(pcfg, batch=2, seed=1):
    """Codes, a random camera and box transforms drawn by the port's
    samplers: (numpy for JAX, tensors for the port)."""
    gen = torch.Generator().manual_seed(seed)
    codes = p_gen.sample_latent_codes(gen, pcfg, batch)
    cams = p_gen.sample_random_camera(gen, pcfg, batch)
    trans = p_bbox.sample_transformations(gen, pcfg.bbox, batch)
    jax_side = (j_gen.LatentCodes(*(c.numpy() for c in codes)), tuple(c.numpy() for c in cams),
                tuple(t.numpy() for t in trans))
    return jax_side, (codes, cams, trans)


def _close(got, want, tol=IMAGE_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# ------------------------------------------------------------- camera, boxes
LINSPACE_TOL = 2.4e-7  # two f32 ulps of 1: torch.linspace rounds otherwise than jnp's


def test_linspace_within_two_ulps_of_jnp():
    """The pixel grid, depth steps and mesh grids use ``torch.linspace``:
    within 2.4e-7 of ``jnp.linspace`` (not bit-equal)."""
    for start, stop, num in ((-1.0, 1.0, 8), (-1.0, 1.0, 16), (0.0, 1.0, 64), (-1.0, 1.0, 128),
                             (0.0, 1.0, 6), (-1.0, 1.0, 24)):
        got = torch.linspace(start, stop, num).numpy()
        np.testing.assert_allclose(got, np.asarray(jnp.linspace(start, stop, num)), rtol=0,
                                   atol=LINSPACE_TOL)


def test_camera_functions_match_jax():
    rng = np.random.default_rng(0)
    for fov in (49.13, 10.0):
        _close(p_cam.get_camera_mat(fov), j_cam.get_camera_mat(fov), dict(atol=CAM_TOL, rtol=0))
        _close(torch.linalg.inv(p_cam.get_camera_mat(fov)),
               j_cam.get_camera_mat(fov, invert=False), dict(atol=CAM_TOL, rtol=0))
    u, v = rng.uniform(size=(2, 16)).astype(np.float32)
    _close(p_cam.to_sphere(T(u), T(v)), j_cam.to_sphere(u, v), dict(atol=CAM_TOL, rtol=0))
    eye = rng.standard_normal((16, 3)).astype(np.float32) * 3
    _close(p_cam.look_at(T(eye)), j_cam.look_at(eye), dict(atol=CAM_TOL, rtol=0))
    for vals in ((0.5, 0.5, 0.5), (0.0, 0.1, 1.0), (1.0, 0.9, 0.0)):
        _close(p_cam.get_camera_pose((0.0, 0.3), (0.25, 0.5), (2.0, 3.0), *vals, batch_size=3),
               j_cam.get_camera_pose((0.0, 0.3), (0.25, 0.5), (2.0, 3.0), *vals, batch_size=3),
               dict(atol=CAM_TOL, rtol=0))
    _close(p_cam.get_rotation_matrix(0.37, 2), j_cam.get_rotation_matrix(0.37, 2),
           dict(atol=CAM_TOL, rtol=0))
    pix = p_cam.arange_pixels(16, 2)
    _close(pix, j_cam.arange_pixels(16, 2), dict(atol=LINSPACE_TOL, rtol=0))
    world = np.asarray(j_cam.get_random_pose(jax.random.PRNGKey(3), (0, 1), (0, 1), (2, 3), 2))
    cam = np.tile(np.asarray(j_cam.get_camera_mat(10.0)), (2, 1, 1))
    _close(p_cam.image_points_to_world(pix, T(cam), T(world)),
           j_cam.image_points_to_world(jnp.asarray(pix.numpy()), cam, world),
           dict(atol=CAM_TOL, rtol=0))
    _close(p_cam.origin_to_world(5, T(cam), T(world)), j_cam.origin_to_world(5, cam, world),
           dict(atol=CAM_TOL, rtol=0))
    z1, z2 = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    for t in (0.0, 0.3, 1.0):
        _close(p_cam.interpolate_sphere(T(z1), T(z2), t), j_cam.interpolate_sphere(z1, z2, t),
               dict(atol=CAM_TOL, rtol=0))


def test_random_pose_map_on_jax_draws():
    key = jax.random.PRNGKey(7)
    ranges = ((0.0, 0.2), (0.25, 0.5), (2.0, 3.0))
    ku, kv, kr = jax.random.split(key, 3)
    draws = np.stack([np.asarray(jax.random.uniform(k, (5,))) for k in (ku, kv, kr)])
    _close(p_cam.pose_from_uniforms(T(draws), *ranges),
           j_cam.get_random_pose(key, *ranges, batch_size=5), dict(atol=CAM_TOL, rtol=0))


def _box_draws(key, cfg, batch, prior=None):
    """JAX's draws of ``sample_transformations``, as its key splits make them."""
    ks, kt, kr = jax.random.split(key, 3)
    n = cfg.n_boxes
    scale = jax.random.uniform(ks, (batch, n, 1 if cfg.fix_scale_ratio else 3))
    translation = resample = pick = None
    if prior is not None:
        pick = T(jax.random.randint(kt, (batch,), 0, prior.shape[0])).long()
    else:
        translation = T(jax.random.uniform(kt, (batch, n, 3)))
        if cfg.check_collision:
            rounds = []
            for _ in range(8):
                kt, sub = jax.random.split(kt)
                rounds.append(np.asarray(jax.random.uniform(sub, (batch, n, 3))))
            resample = T(np.stack(rounds))
    return p_bbox.BoxDraws(T(scale), translation, resample,
                           T(jax.random.uniform(kr, (batch, n))), pick)


@pytest.mark.parametrize("case", ["default", "per_axis_scale", "collision", "on_plane", "prior"])
def test_box_transforms_map_on_jax_draws(case):
    kw = dict(n_boxes=3, scale_range_min=(0.2, 0.25, 0.3), scale_range_max=(0.4, 0.5, 0.6),
              translation_range_min=(-0.5, -0.6, -0.1), translation_range_max=(0.5, 0.6, 0.2),
              rotation_range=(0.1, 0.8))
    kw.update({"per_axis_scale": dict(fix_scale_ratio=False),
               "collision": dict(check_collision=True, collision_padding=0.3),
               "on_plane": dict(object_on_plane=True, z_level_plane=-0.07)}.get(case, {}))
    jcfg, pcfg = j_bbox.BBoxConfig(**kw), p_bbox.BBoxConfig(**kw)
    prior = (np.random.default_rng(2).uniform(-0.5, 0.5, (7, 3, 3)).astype(np.float32)
             if case == "prior" else None)
    key = jax.random.PRNGKey(11)
    want = j_bbox.sample_transformations(key, jcfg, 64, prior=prior)
    got = p_bbox.transformations_from_draws(pcfg, _box_draws(key, jcfg, 64, prior),
                                            None if prior is None else T(prior))
    for g_, w_ in zip(got, want):
        _close(g_, w_, dict(atol=CAM_TOL, rtol=0))
    if case == "collision":  # some samples were resampled
        first = _box_draws(key, jcfg, 64)
        assert not np.allclose(got[1].numpy(), (T(kw["translation_range_min"]) + first.translation
                                                * (T(kw["translation_range_max"])
                                                   - T(kw["translation_range_min"]))).numpy())
    # and the sampler's own draws give transforms inside the ranges
    s, t, r = p_bbox.sample_transformations(torch.Generator().manual_seed(0), pcfg, 8)
    assert s.shape == (8, 3, 3) and t.shape == (8, 3, 3) and r.shape == (8, 3, 3, 3)


def test_fixed_transformations_and_box_points_match_jax():
    for kw in (dict(n_boxes=2), dict(n_boxes=2, fix_scale_ratio=False, object_on_plane=True,
                                     z_level_plane=0.3)):
        jcfg, pcfg = j_bbox.BBoxConfig(**kw), p_bbox.BBoxConfig(**kw)
        vals = dict(val_s=[[0.1, 0.5, 0.9], [1.0, 0.0, 0.3]],
                    val_t=[[0.2, 0.4, 0.6], [0.9, 0.1, 0.5]], val_r=[0.25, 0.8])
        got = p_bbox.fixed_transformations(pcfg, 3, **vals)
        want = j_bbox.fixed_transformations(jcfg, 3, **vals)
        for g_, w_ in zip(got, want):
            _close(g_, w_, dict(atol=CAM_TOL, rtol=0))
    p = np.random.default_rng(1).standard_normal((3, 10, 3)).astype(np.float32)
    for i in range(2):
        _close(p_bbox.transform_points_to_box(T(p), *got, box_idx=i),
               j_bbox.transform_points_to_box(p, *want, box_idx=i), dict(atol=CAM_TOL, rtol=0))


def test_background_rotation_and_object_existence_maps_on_jax_draws():
    jcfg, pcfg = _cfgs()
    key = jax.random.PRNGKey(4)
    for rng_ in ((0.0, 0.0), (-0.2, 0.3)):
        jc, pc = (dataclasses.replace(c, bg_rotation_range=rng_) for c in (jcfg, pcfg))
        want = j_gen.sample_bg_rotation(key, jc, 3)
        got = (p_gen.sample_bg_rotation(None, pc, 3) if rng_ == (0.0, 0.0)
               else p_gen.bg_rotation_from_uniform(pc, T(jax.random.uniform(key, ())), 3))
        _close(got, want, dict(atol=CAM_TOL, rtol=0))
    for n in (5, 3, 1):
        jc, pc = (dataclasses.replace(c, bbox=dataclasses.replace(c.bbox, n_boxes=n))
                  for c in (jcfg, pcfg))
        kc, ks = jax.random.split(key)
        probs = (jnp.array([0.19456788, 0.24355003, 0.25269547, 0.30918661]) if n == 5
                 else jnp.ones(max(n - 1, 1)) / max(n - 1, 1))
        _close(p_gen.object_count_probs(pc), probs, dict(atol=1e-7, rtol=0))
        category = T(jax.random.categorical(kc, jnp.log(probs), shape=(64,))).long()
        scores = T(jax.random.uniform(ks, (64, n)))
        got = p_gen.object_existence_from_draws(pc, category, scores)
        assert np.array_equal(got.numpy(), np.asarray(j_gen.sample_object_existence(key, jc, 64)))
        drawn = p_gen.sample_object_existence(torch.Generator().manual_seed(0), pc, 64)
        assert bool(((drawn.sum(-1) >= min(2, n)) & (drawn.sum(-1) <= n)).all())


# ------------------------------------------------------------------ decoders
@pytest.mark.parametrize("enc", ["normal", "gauss", "hash", "small"])
@pytest.mark.parametrize("views", [True, False])
def test_decoders_match_jax(enc, views):
    """Each encoding (hash with ~half its points outside [-1, 1]^3 after the
    /15), with and without view directions (the small decoder: zeros, then
    ``fc_z_view``), the skip at block 2."""
    small = enc == "small"
    jcfg, pcfg = _cfgs(enc="hash" if small else enc, small=small)
    params, g = _models(jcfg, pcfg)
    rng = np.random.default_rng(3)
    pts = (rng.uniform(-1, 1, (2, 300, 3)) * 30.0).astype(np.float32)
    if enc == "hash" or small:
        oob = np.any(np.abs(pts / 15.0) > 1.0, -1)
        assert 0.2 < float(np.mean(oob)) < 0.9
        with torch.no_grad():  # out of the box, every level encodes to zeros
            code = p_dec._encode_hash(T(pts), g.decoder.hash_table, jcfg.decoder.hash_spec
                                      or jcfg.small.hash_spec, 15.0)
        assert bool((code[torch.from_numpy(oob)] == 0).all())
        assert bool((code[torch.from_numpy(~oob)] != 0).any(-1).all())
    rays = rng.standard_normal((2, 300, 3)).astype(np.float32) if views else None
    zs, za = rng.standard_normal((2, 2, Z)).astype(np.float32)
    jdec = params["decoder"]
    if small:
        want = j_dec.apply_small_decoder(jdec, jcfg.small, pts, rays, zs, za)
    else:
        want = j_dec.apply_giraffe_decoder(jdec, jcfg.decoder, pts, rays, zs, za)
    with torch.no_grad():
        got = g.decoder(T(pts), None if rays is None else T(rays), T(zs), T(za))
    for g_, w_ in zip(got, want):
        w_ = np.asarray(w_)
        np.testing.assert_allclose(g_.numpy(), w_, rtol=0, atol=1e-5 * np.abs(w_).max())


def test_decoder_without_z_shape_and_the_skip_rule():
    """``fc_z`` is added only for a given ``z_shape`` (``z_dim > 0``: a
    decoder of ``z_dim`` 0 fails to build in both packages, its
    ``fc_z_view`` drawn from U(+-1/sqrt(0))), and a skip only where
    ``(idx + 1) in skips and idx < len(blocks) - 1``: one at the last block
    is not applied, though its layers are built."""
    kw = dict(hidden_size=16, n_blocks=4, rgb_out_dim=4, n_freq_posenc=3, n_freq_posenc_views=2)
    with pytest.raises(ZeroDivisionError):
        j_dec.init_giraffe_decoder(jax.random.PRNGKey(0), j_dec.DecoderConfig(z_dim=0, **kw))
    with pytest.raises(ZeroDivisionError):
        p_dec.GiraffeDecoder(p_dec.DecoderConfig(z_dim=0, **kw))
    rng = np.random.default_rng(1)
    pts, rays = rng.standard_normal((2, 1, 50, 3)).astype(np.float32)
    zs, za = rng.standard_normal((2, 1, 4)).astype(np.float32)
    for skips, z_shape in (((), None), ((3,), zs), ((1, 2), zs)):
        jc = j_dec.DecoderConfig(z_dim=4, skips=skips, **kw)
        dec = p_dec.GiraffeDecoder(p_dec.DecoderConfig(z_dim=4, skips=skips, **kw))
        p = _jax_tree(dec.state_dict())
        assert len(getattr(dec, "fc_z_skips", ())) == {(): 0, (3,): 0, (1, 2): 2}[skips]
        want = j_dec.apply_giraffe_decoder(p, jc, pts, rays, z_shape, za)
        with torch.no_grad():
            got = dec(T(pts), T(rays), None if z_shape is None else T(z_shape), T(za))
        for g_, w_ in zip(got, want):
            w_ = np.asarray(w_)
            np.testing.assert_allclose(g_.numpy(), w_, rtol=0, atol=1e-5 * np.abs(w_).max())


def test_more_than_one_view_block_fails_in_both():
    """``n_blocks_view > 1`` builds (dim_embed_view + h) -> h layers and
    applies them to the h-wide features, in the JAX package as in the port:
    both raise on the shapes (ROADMAP.md queue 3, a finding about the
    reference)."""
    kw = dict(hidden_size=16, n_blocks=3, n_blocks_view=2, z_dim=8, rgb_out_dim=4,
              n_freq_posenc=2, n_freq_posenc_views=1)
    dec = p_dec.GiraffeDecoder(p_dec.DecoderConfig(**kw))
    x, z = np.ones((1, 5, 3), np.float32), np.ones((1, 8), np.float32)
    with pytest.raises(TypeError):
        j_dec.apply_giraffe_decoder(_jax_tree(dec.state_dict()), j_dec.DecoderConfig(**kw),
                                    x, x, z, z)
    assert dec.blocks_view[0].weight.shape == (16, 16 + 6)
    with pytest.raises(RuntimeError):
        dec(T(x), T(x), T(z), T(z))


# ------------------------------------------------------------ neural renderer
@pytest.mark.parametrize("case", ["nn", "bilinear_feat", "no_rgb_skip", "conv_in", "no_sigmoid"])
def test_neural_renderer_matches_jax(case):
    kw = dict(n_feat=16, input_dim=16, img_size=64, min_feat=8)
    kw.update({"bilinear_feat": dict(upsample_feat="bilinear"),
               "no_rgb_skip": dict(use_rgb_skip=False),
               "conv_in": dict(input_dim=12),
               "no_sigmoid": dict(final_actvn=False)}.get(case, {}))
    jc, pc = j_nr.NeuralRendererConfig(**kw), p_nr.NeuralRendererConfig(**kw)
    nr = p_nr.NeuralRenderer(pc, torch.Generator().manual_seed(2))
    p = _jax_tree(nr.state_dict())
    assert hasattr(nr, "conv_in") == (case == "conv_in")
    x = np.random.default_rng(0).standard_normal((2, 16, 16, kw["input_dim"])).astype(np.float32)
    want = j_nr.apply_neural_renderer(p, jc, x)
    with torch.no_grad():
        got = nr(T(x))
    assert got.shape == (2, 64, 64, 3)
    _close(got, want)


# --------------------------------------------------------------- the forward
FORWARD_CASES = {
    "one_box_no_neural_renderer": dict(nr=False),
    "two_boxes_sum": dict(n_boxes=2),
    "two_boxes_max_gauss": dict(n_boxes=2, maxc=True, enc="gauss"),
    "hash": dict(n_boxes=2, enc="hash"),
    "small": dict(n_boxes=2, enc="hash", small=True),
}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_giraffe_forward_eval_matches_jax(case):
    jcfg, pcfg = _cfgs(**FORWARD_CASES[case])
    params, g = _models(jcfg, pcfg)
    (codes, cams, trans), (pcodes, pcams, ptrans) = _scene(pcfg)
    bg = p_cam.get_rotation_matrix(0.1, 2)
    want = j_forward(params, cfg=jcfg, latent_codes=codes, camera_matrices=cams,
                     transformations=trans, bg_rotation=bg.numpy(), mode="eval")
    with torch.no_grad():
        got = p_gen.giraffe_forward(g, pcfg, latent_codes=pcodes, camera_matrices=pcams,
                                    transformations=ptrans, bg_rotation=bg, mode="eval")
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("case", ["object_mask", "only_background", "not_background",
                                  "alpha_map", "alpha_map_max"])
def test_giraffe_forward_options_match_jax(case):
    jcfg, pcfg = _cfgs(n_boxes=3, maxc=case == "alpha_map_max")
    params, g = _models(jcfg, pcfg)
    (codes, cams, trans), (pcodes, pcams, ptrans) = _scene(pcfg)
    kw = {"object_mask": dict(object_mask=np.array([[1, 0, 1], [0, 1, 1]], np.float32)),
          "only_background": dict(only_render_background=True),
          "not_background": dict(not_render_background=True),
          "alpha_map": dict(return_alpha_map=True),
          "alpha_map_max": dict(return_alpha_map=True, not_render_background=True)}[case]
    want = j_forward(params, cfg=jcfg, latent_codes=codes, camera_matrices=cams,
                     transformations=trans, mode="eval", **kw)
    pkw = {k: T(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    with torch.no_grad():
        got = p_gen.giraffe_forward(g, pcfg, latent_codes=pcodes, camera_matrices=pcams,
                                    transformations=ptrans, mode="eval", **pkw)
    assert got.shape == want.shape
    _close(got, want)


def test_max_composition_takes_the_first_index_on_ties():
    """sigma is 0 after the ReLU for most samples: on a tie the first
    object's feature is taken, as ``jnp.argmax`` takes it."""
    jcfg, pcfg = _cfgs(n_boxes=3, maxc=True)
    rng = np.random.default_rng(0)
    sigma = np.maximum(rng.standard_normal((3, 2, 4, 5)), 0).astype(np.float32)
    sigma[:, :, :2] = 0.0
    sigma[1, :, 2] = sigma[2, :, 2] = 0.7  # a positive tie
    feat = rng.standard_normal((3, 2, 4, 5, 6)).astype(np.float32)
    got = p_gen.composite(pcfg, T(sigma), T(feat))
    want = j_gen._composite(jcfg, sigma, feat)
    for g_, w_ in zip(got, want):
        assert np.array_equal(g_.numpy(), np.asarray(w_))
    assert np.array_equal(got[1][:, :2].numpy(), feat[0][:, :2])
    # the sum composition's zero-density guard
    got = p_gen.composite(dataclasses.replace(pcfg, use_max_composition=False), T(sigma), T(feat))
    want = j_gen._composite(dataclasses.replace(jcfg, use_max_composition=False), sigma, feat)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-6, atol=1e-6)


def test_volume_weights_match_jax():
    rng = np.random.default_rng(5)
    z = np.sort(rng.uniform(0.5, 6.0, (2, 7, 9)), -1).astype(np.float32)
    ray = rng.standard_normal((2, 7, 3)).astype(np.float32)
    sigma = rng.standard_normal((2, 7, 9)).astype(np.float32)
    for last in (1e10, 0.0):
        _close(p_gen.calc_volume_weights(T(z), T(ray), T(sigma), last_dist=last),
               j_gen.calc_volume_weights(z, ray, sigma, last_dist=last),
               dict(rtol=1e-6, atol=1e-7))
    key = jax.random.PRNGKey(2)
    _close(p_gen.add_noise_to_interval(T(z), T(jax.random.uniform(key, z.shape))),
           j_gen._add_noise_to_interval(z, key), dict(rtol=0, atol=1e-6))


def test_giraffe_forward_training_mode_on_jax_draws(monkeypatch):
    """``mode="training"``: the depth jitter and the N(0, 1) density noise of
    each object and the background, JAX's draws injected in its order."""
    jcfg, pcfg = _cfgs(n_boxes=2)
    params, g = _models(jcfg, pcfg)
    (codes, cams, trans), (pcodes, pcams, ptrans) = _scene(pcfg)
    key = jax.random.PRNGKey(9)
    want = j_forward(params, cfg=jcfg, key=key, latent_codes=codes, camera_matrices=cams,
                     transformations=trans, bg_rotation=jnp.eye(3)[None].repeat(2, 0),
                     mode="training")
    krender = jax.random.split(key, 7)[-1]
    krender, sub = jax.random.split(krender)
    draws = {"interval": [T(jax.random.uniform(sub, (2, RES * RES, STEPS)))], "density": []}
    for _ in range(3):
        krender, sub = jax.random.split(krender)
        draws["density"].append(T(jax.random.normal(sub, (2, RES * RES * STEPS))))
    monkeypatch.setattr(p_gen, "interval_noise", lambda gen, shape, dev: draws["interval"].pop(0))
    monkeypatch.setattr(p_gen, "density_noise", lambda gen, shape, dev: draws["density"].pop(0))
    with torch.no_grad():
        got = p_gen.giraffe_forward(g, pcfg, generator=torch.Generator(), latent_codes=pcodes,
                                    camera_matrices=pcams, transformations=ptrans,
                                    bg_rotation=torch.eye(3)[None].repeat(2, 1, 1))
    assert not draws["interval"] and not draws["density"]
    _close(got, want)


def test_giraffe_forward_draws_what_is_not_given():
    """With a generator it draws the scene (a second call with the same seed
    renders the same images); without one it refuses to draw."""
    _, pcfg = _cfgs(n_boxes=2)
    pcfg = dataclasses.replace(pcfg, sample_object_existance=True,
                               bg_rotation_range=(-0.1, 0.1))
    g = p_gen.GiraffeGenerator(pcfg)
    with torch.no_grad():
        a, b = (p_gen.giraffe_forward(g, pcfg, torch.Generator().manual_seed(3), batch_size=2,
                                      mode="eval") for _ in range(2))
        assert torch.equal(a, b) and a.shape == (2, 16, 16, 3) and bool(torch.isfinite(a).all())
        with pytest.raises(ValueError, match="torch.Generator"):
            p_gen.giraffe_forward(g, pcfg, batch_size=2)


# ------------------------------------------------------------------- configs
GIRAFFE_YAMLS = sorted(
    str(p.relative_to(REPO)) for p in list((REPO / "configs" / "64res").glob("*.yaml"))
    + list((REPO / "configs" / "256res").glob("*.yaml")) if "sdf" not in p.name)


class _Flags:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("flags", [{}, dict(i_embed=1), dict(small_net=1),
                                   dict(i_embed=1, finest_res=64, log2_hashmap_size=10),
                                   dict(small_net=1, finest_res=256, log2_hashmap_size=15)],
                         ids=["plain", "hash", "small", "hash_small_grid", "small_grid"])
def test_configs_from_every_giraffe_yaml_match_jax(flags):
    assert len(GIRAFFE_YAMLS) == 13
    for path in GIRAFFE_YAMLS:
        jcfg = j_config.giraffe_config_from_yaml(
            j_load_config(str(REPO / path), default_config_path()), _Flags(**flags))
        pcfg = p_config.giraffe_config_from_yaml(
            load_config(str(REPO / path), p_default()), _Flags(**flags))
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg), path
    jcfg = j_config.giraffe_config_from_yaml(j_load_config(str(REPO / GIRAFFE_YAMLS[0]),
                                                           default_config_path()))
    pcfg = p_config.giraffe_config_from_yaml(load_config(str(REPO / GIRAFFE_YAMLS[0]),
                                                         p_default()))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)


# ------------------------------------------------------------ render programs
PROGRAM_CASES = [(p, 3) for p in p_rend.PROGRAMS] + [("object_rotation", 1),
                                                    ("object_translation_circle", 2)]


@pytest.mark.parametrize("program,n_boxes", PROGRAM_CASES,
                         ids=[f"{p}-{n}" for p, n in PROGRAM_CASES])
def test_render_programs_match_jax_on_jax_draws(program, n_boxes, tmp_path, monkeypatch):
    """Every program's frames and PNG sheet on JAX's draws (the port's
    samplers patched to return them in the order they are drawn); one box
    with a full turn's rotation range sweeps [0, 1], three boxes [0.1, 0.9]."""
    bbox = dict(rotation_range=(0.0, 1.0)) if n_boxes == 1 else None
    jcfg, pcfg = _cfgs(n_boxes=n_boxes, bbox=bbox)
    params, g = _models(jcfg, pcfg)
    monkeypatch.setattr(j_rend, "giraffe_forward", j_forward)
    key = jax.random.PRNGKey(0)
    want = j_rend.render_program(params, jcfg, program, str(tmp_path / "jax"), n_samples=2,
                                 n_steps=3, key=key, save_video=False)
    k1, k2, k3 = jax.random.split(key, 3)
    layout = p_rend._ADD_LAYOUTS.get(program)
    ccfg = (dataclasses.replace(jcfg, bbox=dataclasses.replace(jcfg.bbox,
                                                               n_boxes=layout["n_objs"]))
            if layout else jcfg)
    queue = [_codes(j_gen.sample_latent_codes(k1, ccfg, 2, tmp=0.65)),
             _codes(j_gen.sample_latent_codes(k2, jcfg, 2, tmp=0.65))]
    monkeypatch.setattr(p_rend, "sample_latent_codes", lambda *a, **k: queue.pop(0))
    circle = tuple(map(T, j_bbox.sample_transformations(k3, jcfg.bbox, 2)))
    monkeypatch.setattr(p_rend, "sample_transformations", lambda *a, **k: circle)
    got = p_rend.render_program(g, pcfg, program, str(tmp_path / "port"), n_samples=2, n_steps=3,
                                generator=torch.Generator())
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_, np.asarray(w_), rtol=IMAGE_TOL["rtol"],
                                   atol=2 * IMAGE_TOL["atol"])
    from PIL import Image

    from sdface_gan_tpu_torch.data.png import decode_png

    sheet = decode_png((tmp_path / "port" / f"{program}.png").read_bytes())
    jsheet = np.asarray(Image.open(tmp_path / "jax" / f"{program}.png").convert("RGB"))
    assert sheet.shape == jsheet.shape
    # equal but where a value straddles a uint8 step (one channel of one
    # pixel in two programs' sheets)
    assert int(np.abs(sheet.astype(int) - jsheet.astype(int)).max()) <= 1
    assert float(np.mean(sheet != jsheet)) < 1e-3


@pytest.mark.parametrize("enc", ["normal", "small"])
def test_mesh_extraction_matches_jax(enc, monkeypatch):
    """The alpha volume of object 0 (the points as view directions too)
    within 1e-5 of JAX's, and the same mesh at a level inside its range."""
    jcfg, pcfg = _cfgs(enc="hash" if enc == "small" else enc, small=enc == "small")
    params, _ = _models(jcfg, pcfg)
    if enc == "small":  # its sigma lies in [-0.24, -0.06] here: lift it across 0
        params = jax.tree_util.tree_map(np.copy, params)
        params["decoder"]["sigma_layers"][-1]["b"][0] += 0.15
    g = p_gen.GiraffeGenerator(pcfg)
    g.load_state_dict(jax_giraffe_params_to_state_dict(params, pcfg))
    codes = j_gen.sample_latent_codes(jax.random.PRNGKey(2), jcfg, 1, tmp=0.65)
    seen = {}

    def capture(name, original):
        def fn(alpha, level):
            seen[name] = np.array(alpha)
            return original(alpha, level)
        return fn

    import sdface_gan_tpu.native as j_native

    monkeypatch.setattr(j_native, "marching_cubes", capture("jax", j_native.marching_cubes))
    monkeypatch.setattr(p_rend, "marching_cubes", capture("port", p_rend.marching_cubes))
    j_rend.extract_giraffe_mesh(params, jcfg, codes=codes, resolution=24)
    level = float(0.5 * (seen["jax"].min() + seen["jax"].max()))
    want = j_rend.extract_giraffe_mesh(params, jcfg, codes=codes, resolution=24, level=level)
    got = p_rend.extract_giraffe_mesh(g, pcfg, codes=_codes(codes), resolution=24, level=level)
    np.testing.assert_allclose(seen["port"], seen["jax"], rtol=0, atol=1e-5)
    assert len(got.faces) == len(want.faces) > 0
    np.testing.assert_allclose(got.verts, want.verts, rtol=0, atol=1e-3)


# ------------------------------------------------------------------- dataset
def _image_dir(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    for name in os.listdir(IMAGES):
        if not name.endswith((".npy", ".py")):
            (d / name).write_bytes((IMAGES / name).read_bytes())
    rng = np.random.default_rng(0)
    np.save(d / "stack.npy", rng.uniform(-20, 300, (2, 3, 70, 90)))  # 4-D, CHW, clipped
    (d / "zz_corrupt.png").write_bytes(b"\x89PNG\r\n\x1a\n broken")
    return d


@pytest.mark.parametrize("mode", ["celebA", "random", "center"])
@pytest.mark.parametrize("tanh", [False, True])
def test_images_dataset_equals_jax(tmp_path, mode, tanh):
    d = _image_dir(tmp_path)
    kw = dict(size=24, celebA_center_crop=mode == "celebA", random_crop=mode == "random",
              use_tanh_range=tanh)
    jds, pds = (m.ImagesDataset(str(d / "*"), **kw) for m in (j_images, p_images))
    assert pds.files == jds.files
    rj, rp = np.random.default_rng(5), np.random.default_rng(5)
    for i in list(range(len(jds))) * 2:  # the corrupt file retries from the same rng
        want = jds.__getitem__(i, rj)
        got = pds.__getitem__(i, rp)
        assert got.dtype == want.dtype and np.array_equal(got, want), (i, jds.files[i])


def test_images_loader_equals_jax(tmp_path):
    d = _image_dir(tmp_path)
    jds, pds = (m.ImagesDataset(str(d / "*"), size=16, random_crop=True)
                for m in (j_images, p_images))
    jl = iter(j_images.ImagesLoader(jds, 4, seed=3))
    pl = iter(p_images.ImagesLoader(pds, 4, seed=3))
    for _ in range(5):
        assert np.array_equal(next(pl), next(jl))


# ----------------------------------------------------------------- full width
def _full_width(flags):
    path = str(REPO / "configs" / "256res" / "ffhq_256.yaml")
    return (j_config.giraffe_config_from_yaml(j_load_config(path, default_config_path()),
                                              _Flags(**flags)),
            p_config.giraffe_config_from_yaml(load_config(path, p_default()), _Flags(**flags)))


@pytest.mark.parametrize("flags", [{}, dict(i_embed=1)], ids=["plain", "hash"])
def test_full_width_forward_matches_jax(flags):
    """``ffhq_256`` (z 256, decoder 8 x 128 with rgb_out 256, background 4 x
    64, neural renderer 256 -> 256^2, 64 samples), the hash decoder on the
    upstream grid (16 x 2, T = 2^19), batch 1, fixed camera and box."""
    jcfg, pcfg = _full_width(flags)
    if flags:
        assert pcfg.decoder.hash_spec.table_size == 5291984
    params = jax.tree_util.tree_map(np.asarray, j_init(jax.random.PRNGKey(0), jcfg))
    if flags:  # std 1, so that the encode matters
        params["decoder"]["hash_table"] = np.random.default_rng(0).standard_normal(
            params["decoder"]["hash_table"].shape).astype(np.float32)
    g = p_gen.GiraffeGenerator(pcfg)
    g.load_state_dict(jax_giraffe_params_to_state_dict(params, pcfg))
    codes = j_gen.sample_latent_codes(jax.random.PRNGKey(1), jcfg, 1, tmp=0.65)
    cams = j_gen.fixed_camera(jcfg, 1)
    trans = j_bbox.fixed_transformations(jcfg.bbox, 1)
    want = j_forward(params, cfg=jcfg, latent_codes=codes, camera_matrices=cams,
                     transformations=trans, mode="eval")
    with torch.no_grad():
        got = p_gen.giraffe_forward(g, pcfg, latent_codes=_codes(codes),
                                    camera_matrices=tuple(map(T, cams)),
                                    transformations=tuple(map(T, trans)), mode="eval")
    assert got.shape == (1, 256, 256, 3)
    _close(got, want)


def test_full_width_model_tree_imports_bit_exact(tmp_path, monkeypatch):
    """A flagship-width ``model`` tree (hash decoder, DC discriminator,
    RMSprop states) saved by JAX's ``CheckpointIO``, exported and imported
    by the CLI: ``g`` and ``g_ema`` equal the converter's bit for bit."""
    jcfg, pcfg = _full_width(dict(i_embed=1))
    g = j_init(jax.random.PRNGKey(0), jcfg)
    g_ema = jax.tree_util.tree_map(lambda x: x * 0.5, g)
    d = j_disc.init_dc_discriminator(jax.random.PRNGKey(1),
                                     j_disc.DCDiscConfig(n_feat=512, img_size=256))
    g_tx, d_tx = j_trainer.giraffe_optimizers(j_trainer.GiraffeTrainHParams())
    run = tmp_path / "out" / "ffhq256"
    j_ckpt.CheckpointIO(str(run)).save("model", g=g, d=d, g_ema=g_ema, g_opt=g_tx.init(g),
                                       d_opt=d_tx.init(d), it=7, fid_best=jnp.asarray(12.5))
    export_run(str(run), str(tmp_path / "export"))
    run_out = tmp_path / "port"
    run_out.mkdir()
    os.symlink(REPO / "configs", run_out / "configs")
    monkeypatch.chdir(run_out)
    import_cli.main(["--src", str(tmp_path / "export"), "--config",
                     "configs/256res/ffhq_256.yaml", "--sdf", "0", "--i_embed", "1"])
    got = checkpoints.load_checkpoint(str(run_out / "out" / "ffhq256"), "model")
    assert set(got) == {"g", "g_ema", "it", "fid_best"} and got["it"] == 7
    assert got["fid_best"] == 12.5
    for name, tree in (("g", g), ("g_ema", g_ema)):
        want = jax_giraffe_params_to_state_dict(jax.tree_util.tree_map(np.asarray, tree), pcfg)
        assert set(got[name]) == set(want)
        for k, v in want.items():
            assert got[name][k].dtype == v.dtype and torch.equal(got[name][k], v), k
    model = p_gen.GiraffeGenerator(pcfg)
    model.load_state_dict(got["g_ema"])


# ----------------------------------------------------------- the JAX fixture
def _fixture_samples():
    with np.load(FIXTURE / "samples.npz") as f:
        return {k: f[k] for k in f.files}


def _fixture_cfgs():
    path = str(FIXTURE / "jax_giraffe.yaml")
    flags = _Flags(i_embed=1, log2_hashmap_size=10, finest_res=64)
    return (j_config.giraffe_config_from_yaml(j_load_config(path, default_config_path()), flags),
            p_config.giraffe_config_from_yaml(load_config(path, p_default()), flags))


def _fixture_scene(s, to=np.asarray):
    return (j_gen.LatentCodes(*(to(s[k]) for k in ("z_shape_obj", "z_app_obj", "z_shape_bg",
                                                   "z_app_bg"))),
            (to(s["camera_mat"]), to(s["world_mat"])), (to(s["s"]), to(s["t"]), to(s["r"])),
            to(s["bg_rotation"]))


def test_fixture_is_jax_s():
    """JAX's forward of the exported ``model``'s ``g_ema`` gives the stored
    images (a stale fixture fails here)."""
    jcfg, _ = _fixture_cfgs()
    s = _fixture_samples()
    tree = read_export(str(FIXTURE / "run" / "model.npz"))
    assert set(tree) == {"g", "d", "g_ema", "g_opt", "d_opt", "it", "fid_best"}
    assert int(tree["it"]) == 4 and tree["g_ema"]["decoder"]["hash_table"].shape == (16384, 2)
    codes, cams, trans, bg = _fixture_scene(s)
    got = j_forward(tree["g_ema"], cfg=jcfg, latent_codes=codes, camera_matrices=cams,
                    transformations=trans, bg_rotation=bg, mode="eval")
    np.testing.assert_allclose(np.asarray(got), s["images"], rtol=1e-5, atol=1e-6)
    assert s["images"].shape == (2, 32, 32, 3) and s["rotation_frames"].shape == (3, 2, 32, 32, 3)


@pytest.fixture
def imported(tmp_path, monkeypatch):
    """The fixture imported by the CLI into ``<tmp>/out/jax_giraffe`` (the
    yaml's ``training.out_dir``), cwd there, with a ``tests`` symlink for
    the yaml's data path."""
    (tmp_path / "jax_giraffe.yaml").write_bytes((FIXTURE / "jax_giraffe.yaml").read_bytes())
    os.symlink(REPO / "tests", tmp_path / "tests")
    monkeypatch.chdir(tmp_path)
    import_cli.main(["--src", str(FIXTURE / "run"), "--config", "jax_giraffe.yaml",
                     *FIXTURE_FLAGS])
    return tmp_path / "out" / "jax_giraffe"


def test_fixture_imported_renders_jax_s_images(capsys, imported):
    """``model`` and ``model_0000004`` imported (what is left out printed);
    the port's ``g_ema`` renders JAX's codes, camera,
    transforms and background rotation within ``IMAGE_TOL`` of JAX's
    images, and the ``object_rotation`` frames within it too."""
    assert sorted(os.listdir(imported)) == ["model.pt", "model_0000004.pt"]
    out = capsys.readouterr().out
    assert "model: d, g_opt, d_opt not imported" in out
    _, pcfg = _fixture_cfgs()
    state = checkpoints.CheckpointIO(str(imported)).load("model")
    assert state["it"] == 4 and state["fid_best"] == float("inf")
    g = p_gen.GiraffeGenerator(pcfg)
    g.load_state_dict(state["g_ema"])
    s = _fixture_samples()
    codes, cams, trans, bg = _fixture_scene(s, T)
    with torch.no_grad():
        img = p_gen.giraffe_forward(g.eval(), pcfg, latent_codes=p_gen.LatentCodes(*codes),
                                    camera_matrices=cams, transformations=trans,
                                    bg_rotation=bg, mode="eval")
    _close(img, s["images"])
    frames = p_rend.render_program(g, pcfg, "object_rotation", str(imported / "r"), n_samples=2,
                                   n_steps=3, codes=p_gen.LatentCodes(*codes))
    np.testing.assert_allclose(np.stack(frames), s["rotation_frames"], rtol=IMAGE_TOL["rtol"],
                               atol=2 * IMAGE_TOL["atol"])


def test_render_and_extract_mesh_clis_from_the_fixture(imported):
    """``render --device cpu`` over the yaml's programs with ``--vae 1`` (a
    port-saved VAE ``encoder.pt``, the committed image files) and
    ``--export_meshes 1``, then ``extract_mesh``: finite PNG sheets and a
    ``.ply`` per identity and mesh."""
    _, pcfg = _fixture_cfgs()
    e = VAEEncoder(VAEEncoderConfig(img_size=32, z_size=2 * pcfg.z_dim))
    checkpoints.CheckpointIO(str(imported)).save("encoder", e=e.state_dict())
    flags = FIXTURE_FLAGS[2:] + ["--device", "cpu"]
    p_render_cli.main(["--config", "jax_giraffe.yaml", "--n_samples", "2", "--n_steps", "2",
                       "--vae", "1", "--vae_images", "tests/fixtures/images/head*[gp]",
                       "--export_meshes", "1", "--mesh_res", "16", *flags])
    rendered = sorted(os.listdir(imported / "rendering"))
    assert rendered == ["00_rotation.ply", "01_rotation.ply", "interpolate_app.png",
                        "object_rotation.png"]
    from sdface_gan_tpu_torch.data.png import decode_png

    sheet = decode_png((imported / "rendering" / "object_rotation.png").read_bytes())
    assert sheet.shape == (2 * 32, 2 * 32, 3)
    p_extract_cli.main(["--config", "jax_giraffe.yaml", "--n_meshes", "2", "--resolution", "16",
                        *flags])
    meshes = sorted(os.listdir(imported / "meshes"))
    assert meshes == ["mesh_000.ply", "mesh_001.ply"]
    assert (imported / "meshes" / "mesh_000.ply").read_bytes().startswith(b"ply\n")


def test_vae_codes_match_jax_encoding(tmp_path):
    """``render --vae``'s codes: the VAE (JAX's weights) on the dataset's
    images, reparameterised with the port's eps, split [z_shape | z_app]
    and tiled over the boxes, as the JAX ``render.py`` builds them; the
    background's codes drawn at 0.65 after eps."""
    _, pcfg = _fixture_cfgs()
    pcfg = dataclasses.replace(pcfg, bbox=dataclasses.replace(pcfg.bbox, n_boxes=2))
    ecfg = j_vae.VAEEncoderConfig(img_size=32, z_size=2 * pcfg.z_dim)
    e = j_vae.init_vae_encoder(jax.random.PRNGKey(1), ecfg)
    ckpt = checkpoints.CheckpointIO(str(tmp_path))
    ckpt.save("encoder", e=jax_vae_params_to_state_dict(jax.tree_util.tree_map(np.asarray, e)))
    args = _Flags(vae_images=str(IMAGES / "head*[gp]"), n_samples=3, seed=4)
    cfg = load_config(str(FIXTURE / "jax_giraffe.yaml"), p_default())
    got = p_render_cli.encode_real_images(args, cfg, pcfg, ckpt, torch.device("cpu"))

    imgs = np.stack([j_images.ImagesDataset(args.vae_images, size=32, hflip=False)[i]
                     for i in range(3)])
    mu, logvar = (np.asarray(x) for x in j_vae.apply_vae_encoder(e, ecfg, jnp.asarray(imgs)))
    gen = torch.Generator().manual_seed(4)
    eps = torch.randn(mu.shape, generator=gen).numpy()
    z = mu + np.exp(0.5 * logvar) * eps
    tol = dict(rtol=1e-4, atol=1e-5)
    _close(got.z_shape_obj, np.tile(z[:, None, :pcfg.z_dim], (1, 2, 1)), tol)
    _close(got.z_app_obj, np.tile(z[:, None, pcfg.z_dim:], (1, 2, 1)), tol)
    for code in (got.z_shape_bg, got.z_app_bg):
        assert torch.equal(code, 0.65 * torch.randn((3, pcfg.z_dim_bg), generator=gen))


# ------------------------------------------------------------------ refusals
def test_checkpoint_io_round_trip_and_backup(tmp_path):
    ckpt = checkpoints.CheckpointIO(str(tmp_path / "run"))
    assert not ckpt.exists("model_best") and ckpt.backup_model_best() is None
    ckpt.save("model_best", g={"w": torch.ones(2)}, it=3, fid_best=1.5)
    assert ckpt.exists("model_best")
    state = ckpt.load("model_best")
    assert state["it"] == 3 and torch.equal(state["g"]["w"], torch.ones(2))
    backup = ckpt.backup_model_best()
    assert os.path.basename(backup).startswith("backup_") and backup.endswith("_model_best.pt")
    with pytest.raises(FileNotFoundError):
        ckpt.load("model")


def test_encoder_tree_imports_and_is_told_from_stage_c(tmp_path, capsys):
    """A GIRAFFE run's top-level ``encoder`` ({e, e_opt}) imports its VAE
    (``e_opt`` not imported: GIRAFFE's training is not ported); the SDF stage C's
    ``encoder/encoder`` and a top-level ``encoder`` holding {e, g_ema} are
    refused under ``--sdf 0``, before anything is written."""
    import optax

    _, pcfg = _fixture_cfgs()
    ecfg = j_vae.VAEEncoderConfig(img_size=16, z_size=2 * pcfg.z_dim)
    e = j_vae.init_vae_encoder(jax.random.PRNGKey(0), ecfg)
    run = tmp_path / "run"
    j_ckpt.CheckpointIO(str(run)).save("encoder", e=e, e_opt=optax.adam(5e-4).init(e))
    export_run(str(run), str(tmp_path / "x"))
    checkpoints.import_jax_run(str(tmp_path / "x"), str(tmp_path / "out"), pcfg)
    assert "encoder: e_opt not imported" in capsys.readouterr().out
    got = checkpoints.load_checkpoint(str(tmp_path / "out"), "encoder")
    want = jax_vae_params_to_state_dict(jax.tree_util.tree_map(np.asarray, e))
    assert set(got) == {"e"} and all(torch.equal(got["e"][k], v) for k, v in want.items())
    VAEEncoder(VAEEncoderConfig(img_size=16, z_size=2 * pcfg.z_dim)).load_state_dict(got["e"])

    for where, tree in (("sdf", {"e": e, "g_ema": {"w": jnp.ones(2)}}),
                        ("top", {"e": e, "g_ema": {"w": jnp.ones(2)}})):
        run = tmp_path / f"run_{where}"
        base = run / "encoder" if where == "sdf" else run
        j_ckpt.save_checkpoint(str(base), "encoder", tree)
        export_run(str(run), str(tmp_path / f"x_{where}"))
        with pytest.raises(ValueError, match="--sdf 1" if where == "sdf" else "keys"):
            checkpoints.import_jax_run(str(tmp_path / f"x_{where}"), str(tmp_path / f"o_{where}"),
                                       pcfg)
        assert not (tmp_path / f"o_{where}").exists()


def test_import_refusals(tmp_path, monkeypatch):
    """Before writing anything: a gan2d run (naming ROADMAP), a GIRAFFE
    tree under ``--sdf 1``, an SDF run under ``--sdf 0``, a hash-decoder
    tree imported without ``--i_embed 1``, an existing port checkpoint."""
    (tmp_path / "gan2d.yaml").write_text("method: gan2d\ntraining:\n  out_dir: out/g2d\n")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1 item 7"):
        import_cli.main(["--src", str(FIXTURE / "run"), "--config", "gan2d.yaml", "--sdf", "0"])
    assert not (tmp_path / "out").exists()
    with pytest.raises(ValueError, match="import with --sdf 0"):
        checkpoints.import_jax_run(str(FIXTURE / "run"), str(tmp_path / "o1"),
                                   checkpoints.RunConfigs(None, None, None, None))
    _, pcfg = _fixture_cfgs()
    with pytest.raises(ValueError, match="import with --sdf 1"):
        checkpoints.import_jax_run(str(REPO / "tests" / "fixtures" / "jax_run" / "stage_b"),
                                   str(tmp_path / "o2"), pcfg)
    plain = dataclasses.replace(pcfg, decoder=dataclasses.replace(
        pcfg.decoder, positional_encoding="normal", hash_spec=None))
    with pytest.raises(ValueError, match="--small_net / --i_embed"):
        checkpoints.import_jax_run(str(FIXTURE / "run"), str(tmp_path / "o3"), plain)
    assert not any((tmp_path / o).exists() for o in ("o1", "o2"))
    checkpoints.import_jax_run(str(FIXTURE / "run"), str(tmp_path / "o4"), pcfg)
    with pytest.raises(FileExistsError):
        checkpoints.import_jax_run(str(FIXTURE / "run"), str(tmp_path / "o4"), pcfg)


def test_jax_render_cli_cannot_load_a_hash_model(tmp_path, monkeypatch):
    """A finding about the reference (ROADMAP.md queue 3): the JAX
    ``render.py`` builds its template with ``giraffe_config_from_yaml(cfg)``
    and no flags, so a model trained with ``--i_embed 1`` does not load
    there; the port's ``render`` takes the flags and renders it."""
    import render as j_render_cli

    jcfg, pcfg = _fixture_cfgs()
    tree = read_export(str(FIXTURE / "run" / "model.npz"))
    (tmp_path / "jax_giraffe.yaml").write_bytes((FIXTURE / "jax_giraffe.yaml").read_bytes())
    monkeypatch.chdir(tmp_path)
    j_ckpt.CheckpointIO("out/jax_giraffe").save(
        "model", g_ema=jax.tree_util.tree_map(jnp.asarray, tree["g_ema"]))
    with pytest.raises((KeyError, ValueError, TypeError)):
        j_render_cli.main(["--config", "jax_giraffe.yaml", "--n_samples", "1", "--n_steps", "1"])
    checkpoints.CheckpointIO("out/jax_giraffe").save(
        "model", g_ema=jax_giraffe_params_to_state_dict(tree["g_ema"], pcfg))
    p_render_cli.main(["--config", "jax_giraffe.yaml", "--n_samples", "1", "--n_steps", "1",
                       *FIXTURE_FLAGS[2:], "--device", "cpu"])
    assert (tmp_path / "out" / "jax_giraffe" / "rendering" / "object_rotation.png").exists()
    assert jcfg.decoder.positional_encoding == "hash"
