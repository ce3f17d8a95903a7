"""The last model-level modules of the port against the JAX package, on the CPU:
``ResnetBlockFC`` (``models/layers.py``), the VAE decoder
(``encoder/vae.py``), the ``SDFModel`` bundle (``models/container.py``) and
``LSUNClass`` (``data/dataset.py``).

Weights come from the JAX initializers (``fc_1`` and the decoder's
transposed convolutions redrawn at random where an init would hide a
transpose or a missing flip) and cross by the converters.  Tolerances:
``ResnetBlockFC`` 1e-6, the decoder 1e-5 of its largest magnitude, the
bundle's generator ``IMAGE_TOL`` (rtol 2e-3, atol 2e-4) and its D and
encoder 1e-5 of their largest magnitude; ``LSUNClass`` exact (its arrays
are PIL's bytes / 255 in both packages, the flip and the retry's index
forced by the caller's generator).
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdface_gan_tpu.data import dataset as j_dataset  # noqa: E402
from sdface_gan_tpu.encoder import vae as j_vae  # noqa: E402
from sdface_gan_tpu.geometry import generate_camera_params as j_cams  # noqa: E402
from sdface_gan_tpu.models import container as j_container  # noqa: E402
from sdface_gan_tpu.models import discriminator as j_disc  # noqa: E402
from sdface_gan_tpu.models import generator as j_gen  # noqa: E402
from sdface_gan_tpu.models import layers as j_layers  # noqa: E402
from sdface_gan_tpu.models import renderer as j_rend  # noqa: E402
from sdface_gan_tpu_torch.data import LSUNClass  # noqa: E402
from sdface_gan_tpu_torch.encoder import (  # noqa: E402
    VAEDecoder,
    VAEDecoderConfig,
    VAEEncoderConfig,
)
from sdface_gan_tpu_torch.geometry import CameraParams  # noqa: E402
from sdface_gan_tpu_torch.models import (  # noqa: E402
    GeneratorConfig,
    RendererConfig,
    ResnetBlockFC,
    SDFModel,
    StyleDiscConfig,
    StyleDiscriminator,
    VolumeRenderDiscConfig,
    VolumeRenderDiscriminator,
    generator_forward,
)
from sdface_gan_tpu_torch.native import RecordWriter  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import (  # noqa: E402
    jax_disc_params_to_state_dict,
    jax_params_to_state_dict,
    jax_resnet_block_fc_params_to_state_dict,
    jax_vae_decoder_params_to_state_dict,
    jax_vae_params_to_state_dict,
)

from test_torch_port_models import IMAGE_TOL  # noqa: E402
from test_torch_port_training import _two_threads  # noqa: E402,F401  (autouse: two threads)

IMAGES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "images")


def _t(x):
    return torch.from_numpy(np.array(x))


def _jit(fn):
    """``jax.jit`` with XLA's quick compile: each JAX function here runs once."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0,
                                         "xla_llvm_disable_expensive_passes": True})


def _rel_close(ours, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0, atol=rel * np.abs(ref).max())


# ---------------------------------------------------------------------------
# ResnetBlockFC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size_in,size_out,size_h", [(24, 24, None), (24, 40, None),
                                                     (40, 24, 32)])
def test_resnet_block_fc_matches_jax(size_in, size_out, size_h):
    """With and without the biasless shortcut, ``size_h`` defaulted and
    given; ``fc_1`` redrawn at random (its init is zero, which would hide
    its transpose)."""
    params = j_layers.init_resnet_block_fc(jax.random.PRNGKey(1), size_in, size_out, size_h)
    rng = np.random.default_rng(2)
    params["fc_1"]["w"] = rng.standard_normal(np.shape(params["fc_1"]["w"])).astype(np.float32)
    block = ResnetBlockFC(size_in, size_out, size_h)
    assert ("shortcut" in params) == (block.shortcut is not None) == (size_in != size_out)
    block.load_state_dict(jax_resnet_block_fc_params_to_state_dict(params))
    x = rng.standard_normal((5, size_in)).astype(np.float32)
    with torch.no_grad():
        ours = block(_t(x)).numpy()
    ref = np.asarray(j_layers.apply_resnet_block_fc(params, jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


def test_resnet_block_fc_init_follows_jax():
    """``fc_1``'s weight zero, the shortcut only when the sizes differ, the
    hidden size min(in, out), and the uniform bounds 1/sqrt(size_in) for
    ``fc_0`` and ``shortcut`` and 1/sqrt(size_h) for ``fc_1``'s bias."""
    block = ResnetBlockFC(256, 64, generator=torch.Generator().manual_seed(3))
    ref = jax_resnet_block_fc_params_to_state_dict(
        j_layers.init_resnet_block_fc(jax.random.PRNGKey(3), 256, 64))
    ours = block.state_dict()
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    assert block.size_h == 64 and torch.count_nonzero(ours["fc_1.weight"]) == 0
    for name, bound in (("fc_0.weight", 1 / 16), ("fc_0.bias", 1 / 16),
                        ("shortcut.weight", 1 / 16), ("fc_1.bias", 1 / 8)):
        assert 0.8 * bound < ours[name].abs().max().item() <= bound, name
    assert ResnetBlockFC(16).shortcut is None


# ---------------------------------------------------------------------------
# The VAE decoder
# ---------------------------------------------------------------------------

def test_vae_decoder_matches_jax_on_asymmetric_weights():
    """fc -> BN1d (batch statistics) -> ReLU -> an (h, w, c) 8x8 map -> three
    transposed convs (5x5, stride 2, padding 2, output padding 1) with BN
    and ReLU -> 5x5 conv -> tanh.  The transposed convs' weights are redrawn
    N(0, 1) with a ramp across each kernel, so that no kernel is symmetric
    (a missing or doubled flip would show), and the BN affines at random."""
    cfg_j, cfg_p = j_vae.VAEDecoderConfig(z_size=16, size=32), VAEDecoderConfig(z_size=16, size=32)
    params = jax.tree_util.tree_map(np.asarray, j_vae.init_vae_decoder(jax.random.PRNGKey(4),
                                                                       cfg_j))
    rng = np.random.default_rng(5)
    ramp = np.linspace(0.5, 1.5, 25).reshape(5, 5, 1, 1)
    for block in params["blocks"]:
        w = block["conv"]["w"]
        block["conv"]["w"] = (rng.standard_normal(w.shape) * ramp * 0.1).astype(np.float32)
        for k in ("scale", "bias"):
            block["bn"][k] = rng.uniform(0.5, 1.5, block["bn"][k].shape).astype(np.float32)
    dec = VAEDecoder(cfg_p)
    dec.load_state_dict(jax_vae_decoder_params_to_state_dict(params))
    z = rng.standard_normal((4, 16)).astype(np.float32)
    with torch.no_grad():
        ours = dec(_t(z)).numpy()
    ref = np.asarray(_jit(lambda p, z: j_vae.apply_vae_decoder(p, cfg_j, z))(params, z))
    assert ours.shape == ref.shape == (4, 64, 64, 3)
    _rel_close(ours, ref, 1e-5)
    # the converted layout is torch's own: the transposed weight is [in, out, k, k]
    assert tuple(dec.blocks[1].conv.weight.shape) == (32, 16, 5, 5)


def test_vae_decoder_init_shapes_and_bounds_follow_jax():
    cfg_j, cfg_p = j_vae.VAEDecoderConfig(z_size=16, size=32), VAEDecoderConfig(z_size=16, size=32)
    ref = jax_vae_decoder_params_to_state_dict(j_vae.init_vae_decoder(jax.random.PRNGKey(6),
                                                                      cfg_j))
    ours = VAEDecoder(cfg_p, generator=torch.Generator().manual_seed(6)).state_dict()
    assert {k: tuple(v.shape) for k, v in ours.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    for name in ours:
        if name.endswith(".weight") and ours[name].ndim > 1:
            assert ours[name].abs().max() <= ref[name].abs().max() * 1.05 + 1e-6, name
            assert ours[name].abs().max() >= ref[name].abs().max() * 0.8, name


# ---------------------------------------------------------------------------
# SDFModel
# ---------------------------------------------------------------------------

def _gkw(full_pipeline: bool):
    rkw = dict(type="sdf", out_im_res=16, n_samples=4, style_dim=16, width=16, depth=2)
    return rkw, dict(size=32, style_dim=16, full_pipeline=full_pipeline, channel_multiplier=1,
                     channel_base=16)


def _bundles(stage_b: bool) -> dict:
    """The JAX bundle and the port's for one stage (stage B with the VAE
    encoder), at a small generator with ``channel_base`` 16."""
    rkw, gkw = _gkw(stage_b)
    jcfg = j_gen.GeneratorConfig(renderer=j_rend.RendererConfig(**rkw), **gkw)
    pcfg = GeneratorConfig(renderer=RendererConfig(**rkw), **gkw)
    jm = j_container.SDFModel.create(jax.random.PRNGKey(7), jcfg, with_encoder=stage_b)
    pm = SDFModel.create(pcfg, torch.Generator().manual_seed(7), with_encoder=stage_b,
                         device="cpu")
    return dict(stage_b=stage_b, jcfg=jcfg, pcfg=pcfg, jm=jm, pm=pm,
                converted=SDFModel.from_jax(jm, device="cpu"))


@pytest.fixture(scope="module")
def stage_a_bundles():
    return _bundles(False)


@pytest.fixture(scope="module")
def stage_b_bundles():
    return _bundles(True)


@pytest.fixture(params=["stage_a", "stage_b_with_encoder"])
def bundles(request):
    return request.getfixturevalue(
        "stage_a_bundles" if request.param == "stage_a" else "stage_b_bundles")


def _shapes(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


def test_sdf_model_create_matches_jax(bundles):
    """The configs field by field, the stage's D, the state-dict shapes of
    every module against the converted JAX trees, the EMA copy equal to the
    generator, and the encoder where asked for."""
    b = bundles
    jm, pm = b["jm"], b["pm"]
    assert dataclasses.asdict(pm.gcfg) == dataclasses.asdict(jm.gcfg)
    assert dataclasses.asdict(pm.dcfg) == dataclasses.asdict(jm.dcfg)
    want = ((StyleDiscConfig, StyleDiscriminator) if b["stage_b"]
            else (VolumeRenderDiscConfig, VolumeRenderDiscriminator))
    assert (type(pm.dcfg), type(pm.discriminator)) == want
    assert _shapes(pm.generator.state_dict()) == _shapes(
        jax_params_to_state_dict(jm.generator, b["jcfg"]))
    assert _shapes(pm.discriminator.state_dict()) == _shapes(
        jax_disc_params_to_state_dict(jm.discriminator))
    assert pm.generator_test is not pm.generator
    ema, g = pm.generator_test.state_dict(), pm.generator.state_dict()
    assert ema.keys() == g.keys() and all(torch.equal(ema[k], g[k]) for k in g)
    assert all(a.data_ptr() != c.data_ptr() for a, c in zip(pm.generator_test.parameters(),
                                                            pm.generator.parameters()))
    assert (pm.encoder is None) == (jm.encoder is None) == (not b["stage_b"])
    if b["stage_b"]:
        assert pm.encoder.cfg == VAEEncoderConfig(img_size=32, z_size=16)
        assert _shapes(pm.encoder.state_dict()) == _shapes(
            jax_vae_params_to_state_dict(jm.encoder))


def test_sdf_model_stage_b_d_takes_channel_base_512_in_both_packages(stage_b_bundles):
    """A finding about the reference, followed: the bundle's stage-B D gets
    only ``size`` and ``channel_multiplier`` (JAX ``container.py:57-59``),
    so its ``channel_base`` is the default 512 whatever the generator's."""
    b = stage_b_bundles
    assert b["pcfg"].channel_base == 16
    assert b["pm"].dcfg.channel_base == b["jm"].dcfg.channel_base == 512
    # channel_table's 32^2 entry is channel_base itself: 512 channels, not 16
    assert b["pm"].discriminator.conv_in.conv.weight.shape[0] == 512


def test_sdf_model_from_jax_serves_jax_outputs(bundles):
    """``from_jax`` carries the configs and every tree: the generator (and
    its EMA copy) renders JAX's images, the D gives JAX's logits, the
    encoder JAX's (mu, logvar)."""
    b = bundles
    jm, cm = b["jm"], b["converted"]
    assert dataclasses.asdict(cm.gcfg) == dataclasses.asdict(jm.gcfg)
    assert dataclasses.asdict(cm.dcfg) == dataclasses.asdict(jm.dcfg)
    rng = np.random.default_rng(8)
    z = rng.standard_normal((2, 16)).astype(np.float32)
    jc = j_cams(16, jax.random.PRNGKey(9), batch=2)
    pc = CameraParams(*[_t(x) for x in jc])
    forward = _jit(lambda p, z: j_gen.generator_forward(
        p, jm.gcfg, [z], jc.extrinsics, jc.focal, jc.near, jc.far, randomize_noise=False))
    for which in ("generator", "generator_test"):
        ref = forward(getattr(jm, which), jnp.asarray(z))
        with torch.no_grad():
            out = generator_forward(getattr(cm, which).eval(), cm.gcfg, [_t(z)], pc.extrinsics,
                                    pc.focal, pc.near, pc.far, randomize_noise=False)
        np.testing.assert_allclose(out.thumb_rgb.numpy(), np.asarray(ref.thumb_rgb), **IMAGE_TOL)
        if b["stage_b"]:
            np.testing.assert_allclose(out.rgb.numpy(), np.asarray(ref.rgb), **IMAGE_TOL)
    res = 32 if b["stage_b"] else 16
    x = rng.uniform(-1, 1, (4, res, res, 3)).astype(np.float32)
    with torch.no_grad():
        if b["stage_b"]:
            d_ours = cm.discriminator(_t(x)).numpy()
            d_ref = _jit(lambda p, x: j_disc.apply_style_discriminator(p, jm.dcfg, x))(
                jm.discriminator, jnp.asarray(x))
            mu, logvar = cm.encoder(_t(x))
            jmu, jlogvar = _jit(lambda p, x: j_vae.apply_vae_encoder(p, j_vae.VAEEncoderConfig(
                img_size=32, z_size=16), x))(jm.encoder, jnp.asarray(x))
            _rel_close(mu.numpy(), jmu, 1e-5)
            _rel_close(logvar.numpy(), jlogvar, 1e-5)
        else:
            d_ours = cm.discriminator(_t(x))[0].numpy()
            d_ref = _jit(lambda p, x: j_disc.apply_volume_render_discriminator(p, jm.dcfg, x))(
                jm.discriminator, jnp.asarray(x))[0]
    _rel_close(d_ours, d_ref, 1e-5)


def test_sdf_model_entry_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    rkw, gkw = _gkw(False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SDFModel.create(GeneratorConfig(renderer=RendererConfig(**rkw), **gkw))


# ---------------------------------------------------------------------------
# LSUNClass
# ---------------------------------------------------------------------------

class _Draws:
    """A caller's generator with fixed draws: ``random()`` gives ``flip``
    (above 0.5 flips), ``integers`` gives ``retry`` and records its calls."""

    def __init__(self, flip: float, retry: int):
        self.flip, self.retry, self.calls = flip, retry, []

    def random(self):
        return self.flip

    def integers(self, n):
        self.calls.append(n)
        return self.retry


LSUN_FILES = sorted(n for n in os.listdir(IMAGES)
                    if n.endswith((".jpg", ".png", ".bmp", ".webp")))
MISSING = 3  # no record under this index: the dataset retries


@pytest.fixture(scope="module")
def lsun_store(tmp_path_factory):
    """The committed JPEG, PNG, BMP and WebP fixtures (LSUN's archives hold
    WebP) under zero-padded keys, one
    index left out; a second store keyed ``lsun-<3 digits>`` without a
    ``length`` record."""
    root = tmp_path_factory.mktemp("lsun")
    files = [n for i, n in enumerate(LSUN_FILES) if i != MISSING]
    keyed, prefixed = str(root / "keyed"), str(root / "prefixed")
    with RecordWriter(keyed) as w:
        for i, name in enumerate(LSUN_FILES):
            if i != MISSING:
                w.put(f"{i:05d}", open(os.path.join(IMAGES, name), "rb").read())
        w.put("length", str(len(LSUN_FILES)).encode())
    with RecordWriter(prefixed) as w:
        for i, name in enumerate(files):
            w.put(f"lsun-{i:03d}", open(os.path.join(IMAGES, name), "rb").read())
    return dict(keyed=keyed, prefixed=prefixed, n_prefixed=len(files))


@pytest.mark.parametrize("tanh", [False, True])
@pytest.mark.parametrize("flip", [0.1, 0.9])
def test_lsun_class_matches_jax_on_every_image_kind(lsun_store, flip, tanh):
    """Every committed image kind centre-cropped to its shorter side (the
    178 x 218 JPEGs and WebPs, the 64 x 48 PNGs and BMPs, the 128 x 96 and
    512^2 WebPs) and LANCZOS-resized to
    48^2; flipped when the draw is above 0.5; [0, 1] or [-1, 1]."""
    ours = LSUNClass(lsun_store["keyed"], size=48, use_tanh_range=tanh)
    ref = j_dataset.LSUNClass(lsun_store["keyed"], size=48, use_tanh_range=tanh)
    assert len(ours) == len(ref) == len(LSUN_FILES)
    for i in range(len(LSUN_FILES)):
        a = ours.__getitem__(i, _Draws(flip, retry=0))
        b = ref.__getitem__(i, _Draws(flip, retry=0))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (48, 48, 3)
        assert np.array_equal(a, b), LSUN_FILES[i]
        lo = -1.0 if tanh else 0.0
        assert a.min() >= lo and a.max() <= 1.0
    ours.close()


def test_lsun_class_retries_a_missing_key_at_the_drawn_index(lsun_store):
    mine, theirs = _Draws(0.9, retry=5), _Draws(0.9, retry=5)
    ours = LSUNClass(lsun_store["keyed"], size=32)
    ref = j_dataset.LSUNClass(lsun_store["keyed"], size=32)
    a, b = ours.__getitem__(MISSING, mine), ref.__getitem__(MISSING, theirs)
    assert np.array_equal(a, b) and np.array_equal(a, ours.__getitem__(5, _Draws(0.9, 0)))
    assert mine.calls == theirs.calls == [len(LSUN_FILES)]
    ours.close()


def test_lsun_class_prefix_key_width_and_length_from_the_store(lsun_store):
    """No ``length`` record: the store's record count; keys
    ``f"{prefix}{index:0{key_width}d}"``; and a caller's numpy generator."""
    kw = dict(size=40, key_width=3, resolution_prefix="lsun-", hflip=True)
    ours = LSUNClass(lsun_store["prefixed"], **kw)
    ref = j_dataset.LSUNClass(lsun_store["prefixed"], **kw)
    assert len(ours) == len(ref) == lsun_store["n_prefixed"]
    for i in range(len(ours)):
        a = ours.__getitem__(i, np.random.default_rng(i))
        b = ref.__getitem__(i, np.random.default_rng(i))
        assert np.array_equal(a, b)
    no_flip = LSUNClass(lsun_store["prefixed"], hflip=False, **{
        k: v for k, v in kw.items() if k != "hflip"})
    assert np.array_equal(no_flip.__getitem__(0, _Draws(0.9, 0)),
                          ours.__getitem__(0, _Draws(0.1, 0)))
    ours.close()


def test_lsun_class_raises_when_every_try_misses(lsun_store):
    """Ten tries at missing keys: the port names the keys it tried (JAX
    fails inside ``Image.open(None)``)."""
    draws = _Draws(0.9, retry=MISSING)
    with pytest.raises(KeyError, match="10 keys tried"):
        LSUNClass(lsun_store["keyed"]).__getitem__(MISSING, draws)
    assert len(draws.calls) == 10
    with pytest.raises(Exception):
        j_dataset.LSUNClass(lsun_store["keyed"]).__getitem__(MISSING, _Draws(0.9, MISSING))
