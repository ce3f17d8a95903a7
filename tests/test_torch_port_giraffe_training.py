"""GIRAFFE's training on the CPU, the port against ``sdface_gan_tpu/giraffe/``
in f32, same weights and inputs:

* the DC discriminator (logits and its NHWC features) and the ResNet
  discriminator at 16^2, 32^2 and 64^2, the ResNet block and the 3/2/1
  pool, on weights carried across either way: <= 1e-5 of the output's max;
* ``compute_bce`` and ``compute_grad2``: 1e-6;
* RMSprop and the Adam branch against optax over 13 steps, with near-zero
  and zero gradients among them: 1e-5;
* the D, G (plain and hash, the table's gradient included) and VAE-encoder
  steps on JAX's own draws (the ``jax.random`` calls repeated): each loss
  within 1e-4 relative and each gradient within 1e-3 of its norm, against
  JAX's step functions with an optax transform that keeps the gradient
  as its state; each step fills no other module's ``.grad``; the EMA
  within 1e-6 of JAX's after a real RMSprop step;
* ``dc_disc_config_from_yaml`` on every GIRAFFE yaml;
* the committed JAX run (``tests/fixtures/jax_giraffe_run/``) imported with
  every tree (``d_opt``'s nu element for element), and one iteration from
  its it-4 state against JAX's iteration 5 on the same draws and batch;
  the refusals of the optimizer-state import;
* the CLI (``train --sdf 0 --device cpu``) on the fixture's yaml: one
  ``--vae 1`` run cut by ``--exit-after`` (exit 3), resumed to the end with
  a ``validate_every`` FID; the imported fixture resumed at it 5; no card
  without ``--device cpu``.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from sdface_gan_tpu.config import load_config as j_load_config  # noqa: E402
from sdface_gan_tpu.config.yaml_config import default_config_path  # noqa: E402
from sdface_gan_tpu.encoder import vae as j_vae  # noqa: E402
from sdface_gan_tpu.giraffe import bbox as j_bbox  # noqa: E402
from sdface_gan_tpu.giraffe import config as j_config  # noqa: E402
from sdface_gan_tpu.giraffe import discriminator as j_disc  # noqa: E402
from sdface_gan_tpu.giraffe import generator as j_gen  # noqa: E402
from sdface_gan_tpu.giraffe import trainer as j_trainer  # noqa: E402
from sdface_gan_tpu_torch import train as train_cli  # noqa: E402
from sdface_gan_tpu_torch.config import load_config  # noqa: E402
from sdface_gan_tpu_torch.config.yaml_config import default_config_path as p_default  # noqa: E402
from sdface_gan_tpu_torch.data.images import ImagesDataset, ImagesLoader  # noqa: E402
from sdface_gan_tpu_torch.encoder.vae import VAEEncoder  # noqa: E402
from sdface_gan_tpu_torch.giraffe import config as p_config  # noqa: E402
from sdface_gan_tpu_torch.giraffe import discriminator as p_disc  # noqa: E402
from sdface_gan_tpu_torch.giraffe import generator as p_gen  # noqa: E402
from sdface_gan_tpu_torch.giraffe import trainer as p_trainer  # noqa: E402
from sdface_gan_tpu_torch.giraffe.train_loop import giraffe_run_configs  # noqa: E402
from sdface_gan_tpu_torch.training.ema import accumulate  # noqa: E402
from sdface_gan_tpu_torch.training.optim import RMSprop, giraffe_optimizers  # noqa: E402
from sdface_gan_tpu_torch.utils import checkpoints  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import (  # noqa: E402
    jax_dc_disc_params_to_state_dict,
    jax_giraffe_params_to_state_dict,
    jax_resnet_disc_params_to_state_dict,
    jax_vae_params_to_state_dict,
)
from sdface_gan_tpu_torch.utils.jax_export import read_export, rmsprop_state  # noqa: E402

from test_torch_port_training import _two_threads  # noqa: E402,F401  (autouse: two threads)
from test_torch_port_giraffe import (  # noqa: E402
    FIXTURE,
    FIXTURE_FLAGS,
    GIRAFFE_YAMLS,
    REPO,
    T,
    _cfgs,
    _Flags,
    _jax_tree,
    _models,
)

OUT_TOL = 1e-5  # of the output's max
# loss relative; gradient, of its norm plus the repository's floor (a tensor
# whose gradient is a near-cancelling sum, sigma_out's bias where few points
# lie in the box, cannot hold 1e-3 of its own ~1e-8 norm in f32)
LOSS_RTOL, GRAD_TOL, GRAD_ATOL = 1e-4, 1e-3, 1e-6
BATCH = 2
HP = dict(batch_size=BATCH)
IMG = 16  # the images of test_torch_port_giraffe's small model: its 8^2 volume, one 2x block


def _jit(fn, **kw):
    """``jax.jit`` with XLA's quick compile: each JAX function here runs once
    or twice, and eagerly JAX compiles every operation apart."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0,
                                         "xla_llvm_disable_expensive_passes": True}, **kw)


def _of_max(got, want, tol=OUT_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)), 1e-30)


def _rng(seed=0):
    return np.random.default_rng(seed)


# ----------------------------------------------------------- discriminators
@functools.lru_cache(maxsize=None)
def _j_dc(cfg):
    return _jit(functools.partial(j_disc.apply_dc_discriminator, cfg=cfg))


@pytest.mark.parametrize("size", [16, 32, 64])
def test_dc_discriminator_matches_jax(size):
    """Logits and the NHWC features, element for element, both ways: JAX's
    init through the converter, the port's init through the inverse."""
    jcfg, pcfg = (j_disc.DCDiscConfig(n_feat=32, img_size=size),
                  p_disc.DCDiscConfig(n_feat=32, img_size=size))
    x = _rng(size).random((3, size, size, 3), dtype=np.float32)
    jp = _jit(j_disc.init_dc_discriminator, static_argnums=1)(jax.random.PRNGKey(size), jcfg)
    from_jax = p_disc.DCDiscriminator(pcfg)
    from_jax.load_state_dict(jax_dc_disc_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jp)))
    ours = p_disc.DCDiscriminator(pcfg, torch.Generator().manual_seed(size))
    for params, model in ((jp, from_jax), (_jax_tree(ours.state_dict()), ours)):
        want_logits, want_feat = _j_dc(jcfg)(params, x=x)
        with torch.no_grad():
            logits, feat = model(T(x))
        assert feat.shape == (3, 32 * 16) and logits.shape == (3, 1)
        _of_max(logits, want_logits)
        _of_max(feat, want_feat)


@pytest.mark.parametrize("size", [16, 32, 64])
def test_resnet_discriminator_matches_jax(size):
    jcfg = j_disc.ResnetDiscConfig(img_size=size, nfilter=4, nfilter_max=16)
    pcfg = p_disc.ResnetDiscConfig(img_size=size, nfilter=4, nfilter_max=16)
    x = _rng(size).random((2, size, size, 3), dtype=np.float32)
    jp = _jit(j_disc.init_resnet_discriminator, static_argnums=1)(jax.random.PRNGKey(size),
                                                                   jcfg)
    d = p_disc.ResnetDiscriminator(pcfg)
    d.load_state_dict(jax_resnet_disc_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jp)))
    want = _jit(functools.partial(j_disc.apply_resnet_discriminator, cfg=jcfg))(jp, x=x)
    with torch.no_grad():
        _of_max(d(T(x)), want)
    assert sorted(k for k in d.state_dict() if "conv_s" in k) == [
        f"blocks.{i}.conv_s.weight" for i, (fi, fo) in enumerate(jcfg.block_channels())
        if fi != fo]


@pytest.mark.parametrize("fin,fout", [(4, 4), (4, 8)])
def test_resnet_block_and_pool_match_jax(fin, fout):
    """The block (``conv_s`` only when fin != fout) and the 3/2/1 average
    pool, which divides by 9 at the border, on even and odd sizes."""
    block = p_disc.ResnetBlock(fin, fout, torch.Generator().manual_seed(fin + fout))
    params = _jax_tree(block.state_dict())
    assert ("conv_s" in params) == (fin != fout)
    for hw in (8, 7):
        x = _rng(hw).standard_normal((2, hw, hw, fin), dtype=np.float32)
        with torch.no_grad():
            got = block(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            pooled = p_disc.avg_pool_3_2_1(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        _of_max(got, j_disc._apply_resnet_block(params, jnp.asarray(x)))
        _of_max(pooled, j_disc._avg_pool_3_2_1(jnp.asarray(x)))
    corner = p_disc.avg_pool_3_2_1(torch.ones(1, 1, 4, 4))[0, 0, 0, 0]
    assert float(corner) == pytest.approx(4.0 / 9.0)


# --------------------------------------------------------------- the losses
def test_bce_and_grad2_match_jax():
    logits = _rng(1).standard_normal((5, 1), dtype=np.float32) * 4
    for target in (0.0, 1.0):
        np.testing.assert_allclose(float(p_trainer.compute_bce(T(logits), target)),
                                   float(j_trainer.compute_bce(jnp.asarray(logits), target)),
                                   rtol=1e-6, atol=1e-7)
    cfg = p_disc.DCDiscConfig(n_feat=16, img_size=16)
    d = p_disc.DCDiscriminator(cfg, torch.Generator().manual_seed(2))
    params = _jax_tree(d.state_dict())
    jcfg = j_disc.DCDiscConfig(n_feat=16, img_size=16)
    x = _rng(2).random((3, 16, 16, 3), dtype=np.float32)
    want = j_trainer.compute_grad2(lambda img: j_disc.apply_dc_discriminator(params, jcfg, img)[0],
                                   jnp.asarray(x))
    xt = T(x).requires_grad_(True)
    got = p_trainer.compute_grad2(d(xt)[0], xt)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-9)
    assert got.requires_grad  # its graph reaches D's parameters


# ------------------------------------------------------------ the optimizers
def _grad_sequence(shapes, n=13):
    """Gradients of mixed scale: ordinary, near-zero (1e-6) and zero steps,
    where an eps outside the root would move the parameters 100x more."""
    rng = _rng(3)
    scales = [1.0, 1e-6, 0.0, 0.3, 1e-5, 1.0, 0.0, 1e-6, 2.0, 1e-4, 1.0, 1e-6, 0.5][:n]
    return [{k: (rng.standard_normal(s) * sc).astype(np.float32) for k, s in shapes.items()}
            for sc in scales]


@pytest.mark.parametrize("kind", ["rmsprop", "adam"])
def test_optimizers_match_optax_over_13_steps(kind):
    shapes = {"w": (4, 3), "b": (3,), "t": (16, 2)}
    rng = _rng(4)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    hp = p_trainer.GiraffeTrainHParams(lr_g=5e-4, lr_d=1e-4,
                                       optimizer="RMSprop" if kind == "rmsprop" else "adam")
    tx = (optax.rmsprop(hp.lr_g, decay=0.99, eps=1e-8) if kind == "rmsprop"
          else optax.adam(hp.lr_g))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(T(v)) for k, v in p0.items()})
    opt, _ = giraffe_optimizers(hp, module, torch.nn.Linear(1, 1))
    assert isinstance(opt, RMSprop if kind == "rmsprop" else torch.optim.Adam)
    for grads in _grad_sequence(shapes):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in module.items():
            p.grad = T(grads[k])
        opt.step()
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-7)
    if kind == "rmsprop":
        nu = {k: opt.state[p]["nu"] for k, p in module.items()}
        for k in shapes:
            np.testing.assert_allclose(nu[k].numpy(), np.asarray(state[0].nu[k]), rtol=1e-5,
                                       atol=1e-12)


def test_torch_rmsprop_is_not_optax_s():
    """Why the port has its own: ``torch.optim.RMSprop`` adds eps outside the
    root, and a near-zero gradient (1e-6) moves its parameter ~900 x more."""
    g = np.full((3,), 1e-6, np.float32)
    p = torch.nn.Parameter(torch.zeros(3))
    ours = RMSprop([p], 1e-3)
    p.grad = T(g)
    ours.step()
    q = torch.nn.Parameter(torch.zeros(3))
    theirs = torch.optim.RMSprop([q], lr=1e-3, alpha=0.99, eps=1e-8)
    q.grad = T(g)
    theirs.step()
    assert abs(q[0].item()) > 500 * abs(p[0].item()) > 0


# ------------------------------------------------------------- the steps
def _capture_tx():
    """An optax transform whose updates are zero and whose state becomes the
    gradient: JAX's own step function then returns its gradient exactly."""
    zeros = functools.partial(jax.tree_util.tree_map, jnp.zeros_like)
    return optax.GradientTransformation(zeros, lambda u, s, p=None: (zeros(u), u))


class _Capture(torch.optim.Optimizer):
    """Records each parameter's ``.grad`` by name and leaves it unchanged."""

    def __init__(self, module):
        super().__init__(module.parameters(), {})
        self.names = {id(p): n for n, p in module.named_parameters()}
        self.grads = {}

    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                self.grads[self.names[id(p)]] = p.grad.clone()


def _close_grads(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        err, scale = (got[k] - w).norm().item(), w.norm().item()
        assert err <= GRAD_TOL * scale + GRAD_ATOL, (k, err, scale)


def _close_loss(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL, atol=1e-7)


def _jax_draw_arrays(key, cfg, b, codes_key=None):
    key, k1, k2, k3, k4, _, krender = jax.random.split(key, 7)
    codes = j_gen.sample_latent_codes(k1 if codes_key is None else codes_key, cfg, b)
    cams = j_gen.sample_random_camera(k2, cfg, b)
    trans = j_bbox.sample_transformations(k3, cfg.bbox, b)
    bg = j_gen.sample_bg_rotation(k4, cfg, b)
    n, s = cfg.resolution_vol ** 2, cfg.n_ray_samples
    krender, sub = jax.random.split(krender)
    interval = jax.random.uniform(sub, (b, n, s))
    dens = []
    for _ in range(cfg.n_boxes + 1):
        krender, sub = jax.random.split(krender)
        dens.append(jax.random.normal(sub, (b, n * s)))
    return codes, cams, trans, bg, interval, dens


def _jax_draws(key, jcfg, b, codes_key=None):
    """The port's draws holding what JAX's ``giraffe_forward(key=key)``
    draws in training mode (its codes from ``codes_key`` when given, as
    the encoder step draws them)."""
    codes, cams, trans, bg, interval, dens = _jit(_jax_draw_arrays, static_argnums=(1, 2))(
        key, jcfg, b, codes_key)
    return p_trainer.GiraffeDraws(
        None, p_gen.LatentCodes(*map(T, codes)), tuple(map(T, cams)), tuple(map(T, trans)),
        T(bg), p_gen.RenderNoise(T(interval), tuple(map(T, dens))))


def _step_cfgs(enc):
    jcfg, pcfg = _cfgs(enc=enc)
    return ((jcfg, j_disc.DCDiscConfig(n_feat=16, img_size=IMG), j_trainer.GiraffeTrainHParams(**HP)),
            (pcfg, p_disc.DCDiscConfig(n_feat=16, img_size=IMG),
             p_trainer.GiraffeTrainHParams(**HP)))


@functools.lru_cache(maxsize=None)
def _step_models(enc):
    """The port's G (hash table at std 1) and D with their JAX trees."""
    (jcfg, jd, _), (pcfg, pd, _) = _step_cfgs(enc)
    gparams, g = _models(jcfg, pcfg)
    d = p_disc.DCDiscriminator(pd, torch.Generator().manual_seed(5))
    return gparams, _jax_tree(d.state_dict()), g, d


def _fresh(module):
    import copy

    m = copy.deepcopy(module)
    for p in m.parameters():
        p.requires_grad_(True)
        p.grad = None
    return m


def _named(converter, tree, *args):
    return converter(jax.tree_util.tree_map(np.asarray, tree), *args)


X_REAL = _rng(6).random((BATCH, IMG, IMG, 3), dtype=np.float32)


@pytest.mark.parametrize("enc", ["normal", "hash"])
def test_d_step_matches_jax(enc):
    (jcfg, jd, jhp), (pcfg, pd, php) = _step_cfgs(enc)
    gparams, dparams, g, d = _step_models(enc)
    key = jax.random.PRNGKey(11)
    step = _jit(j_trainer.make_giraffe_d_step(jcfg, jd, jhp, _capture_tx()))
    _, grads, metrics = step(gparams, dparams, _capture_tx().init(dparams), key, X_REAL)
    g, d = _fresh(g), _fresh(d)
    opt = _Capture(d)
    got = p_trainer.giraffe_d_step(g, d, opt, pcfg, php, T(X_REAL), _jax_draws(key, jcfg, BATCH))
    for k in ("discriminator", "regularizer"):
        _close_loss(got[k], metrics[k])
    _close_grads(opt.grads, _named(jax_dc_disc_params_to_state_dict, grads))
    assert all(p.grad is None for p in list(g.parameters()) + list(d.parameters()))


@pytest.mark.parametrize("enc", ["normal", "hash"])
def test_g_step_matches_jax(enc):
    """Every leaf of G, the hash table's too, and no gradient into D."""
    (jcfg, jd, jhp), (pcfg, pd, php) = _step_cfgs(enc)
    gparams, dparams, g, d = _step_models(enc)
    key = jax.random.PRNGKey(12)
    step = _jit(j_trainer.make_giraffe_g_step(jcfg, jd, jhp, _capture_tx()))
    _, grads, _, metrics = step(gparams, dparams, _capture_tx().init(gparams), gparams, key)
    g, d = _fresh(g), _fresh(d)
    opt = _Capture(g)
    got = p_trainer.giraffe_g_step(g, d, opt, _fresh(g), pcfg, php, _jax_draws(key, jcfg, BATCH))
    _close_loss(got["generator"], metrics["generator"])
    want = _named(jax_giraffe_params_to_state_dict, grads, pcfg)
    _close_grads(opt.grads, want)
    if enc == "hash":
        assert float(torch.linalg.norm(want["decoder.hash_table"])) > 0
    assert all(p.grad is None and p.requires_grad for p in d.parameters())


def test_e_step_matches_jax():
    """The VAE step: summed KL plus summed feature matching on JAX's eps, codes,
    camera, boxes and noise; the encoder's gradients only."""
    (jcfg, jd, jhp), (pcfg, pd, php) = _step_cfgs("hash")
    gparams, dparams, g, d = _step_models("hash")
    ecfg = j_vae.VAEEncoderConfig(img_size=IMG, z_size=2 * jcfg.z_dim)
    eparams = jax.tree_util.tree_map(np.asarray, _jit(j_vae.init_vae_encoder, static_argnums=1)(
        jax.random.PRNGKey(3), ecfg))
    key = jax.random.PRNGKey(13)
    step = _jit(j_trainer.make_giraffe_encoder_step(jcfg, jd, jhp, _capture_tx()))
    _, grads, metrics = step(eparams, gparams, dparams, _capture_tx().init(eparams), key, X_REAL)

    e = VAEEncoder(p_trainer.encoder_config(pcfg, IMG))
    e.load_state_dict(jax_vae_params_to_state_dict(eparams))
    kz, kg = jax.random.split(key)
    eps = T(jax.random.normal(kz, (BATCH, 2 * jcfg.z_dim)))
    draws = p_trainer.EncoderDraws(eps, _jax_draws(kg, jcfg, BATCH,
                                                   codes_key=jax.random.split(kg, 1)[0]))
    g, d = _fresh(g), _fresh(d)
    opt = _Capture(e)
    got = p_trainer.giraffe_e_step(e, g, d, opt, pcfg, T(X_REAL), draws)
    for k in ("encoder", "e_kl"):
        _close_loss(got[k], metrics[k])
    _close_grads(opt.grads, _named(jax_vae_params_to_state_dict, grads))
    assert all(p.grad is None and p.requires_grad for p in list(g.parameters())
               + list(d.parameters()))


def test_ema_matches_jax():
    """After a real RMSprop G step: ``0.999 * ema + 0.001 * g`` over every
    leaf of G, within 1e-6 of JAX's."""
    (jcfg, jd, jhp), (pcfg, _, _) = _step_cfgs("hash")
    gparams, dparams, g, _ = _step_models("hash")
    ema_tree = _jax_tree(p_gen.GiraffeGenerator(pcfg, torch.Generator().manual_seed(7))
                         .state_dict())
    tx = optax.rmsprop(jhp.lr_g, decay=0.99, eps=1e-8)
    step = _jit(j_trainer.make_giraffe_g_step(jcfg, jd, jhp, tx))
    new_g, _, new_ema, _ = step(gparams, dparams, tx.init(gparams), ema_tree,
                                jax.random.PRNGKey(14))
    ema = p_gen.GiraffeGenerator(pcfg)
    ema.load_state_dict(_named(jax_giraffe_params_to_state_dict, ema_tree, pcfg))
    g_new = p_gen.GiraffeGenerator(pcfg)
    g_new.load_state_dict(_named(jax_giraffe_params_to_state_dict, new_g, pcfg))
    accumulate(ema, g_new, p_trainer.GiraffeTrainHParams().ema_beta)
    want = _named(jax_giraffe_params_to_state_dict, new_ema, pcfg)
    for k, v in ema.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-6)


def test_dc_disc_configs_from_every_giraffe_yaml_match_jax():
    assert len(GIRAFFE_YAMLS) == 13
    for path in GIRAFFE_YAMLS:
        want = j_config.dc_disc_config_from_yaml(j_load_config(str(REPO / path),
                                                               default_config_path()))
        got = p_config.dc_disc_config_from_yaml(load_config(str(REPO / path), p_default()))
        assert dataclasses.asdict(got) == dataclasses.asdict(want), path
        assert got.channels() == want.channels()


# ------------------------------------------------------------ the fixture
def _fixture_run_configs():
    path = str(FIXTURE / "jax_giraffe.yaml")
    flags = _Flags(i_embed=1, log2_hashmap_size=10, finest_res=64)
    jcfg = j_config.giraffe_config_from_yaml(j_load_config(path, default_config_path()), flags)
    return jcfg, giraffe_run_configs(load_config(path, p_default()), flags)


@pytest.fixture(scope="module")
def imported_fixture(tmp_path_factory):
    out = tmp_path_factory.mktemp("imported")
    _, configs = _fixture_run_configs()
    written = checkpoints.import_jax_run(str(FIXTURE / "run"), str(out), configs)
    assert sorted(os.path.basename(p) for p in written) == ["model.pt", "model_0000004.pt"]
    return out


def test_fixture_model_imports_every_tree(imported_fixture, capsys):
    """``model`` {g, d, g_ema, g_opt, d_opt, it, fid_best}: every state loads
    into the port's modules and RMSprop, and ``d_opt``'s nu is JAX's element
    for element; ``model_0000004`` {g, d, g_ema, it}."""
    tree = read_export(str(FIXTURE / "run" / "model.npz"))
    _, (gcfg, dcfg, hp, _) = _fixture_run_configs()
    state = checkpoints.load_checkpoint(str(imported_fixture), "model")
    assert set(state) == {"g", "d", "g_ema", "g_opt", "d_opt", "it", "fid_best"}
    assert state["it"] == 4 and state["fid_best"] == float("inf")
    g, d = p_gen.GiraffeGenerator(gcfg), p_disc.DCDiscriminator(dcfg)
    g.load_state_dict(state["g"])
    d.load_state_dict(state["d"])
    g_opt, d_opt = giraffe_optimizers(hp, g, d)
    g_opt.load_state_dict(state["g_opt"])
    d_opt.load_state_dict(state["d_opt"])
    want = jax_dc_disc_params_to_state_dict(tree["d_opt"][0]["nu"])
    for name, p in d.named_parameters():
        assert torch.equal(d_opt.state[p]["nu"], want[name]), name
    g_nu = jax_giraffe_params_to_state_dict(tree["g_opt"][0]["nu"], gcfg)
    assert len(g_opt.state) == len(g_nu) == len(list(g.parameters()))
    for name, p in g.named_parameters():
        assert torch.equal(g_opt.state[p]["nu"], g_nu[name]), name
    assert float(g_nu["decoder.hash_table"].abs().max()) > 0
    backup = checkpoints.load_checkpoint(str(imported_fixture), "model_0000004")
    assert set(backup) == {"g", "d", "g_ema", "it"}
    assert "not imported" not in capsys.readouterr().out


def test_rmsprop_state_refusals():
    """A leaf count other than the parameters', and another optimizer's
    state, raise."""
    tree = read_export(str(FIXTURE / "run" / "model.npz"))
    _, (_, dcfg, hp, _) = _fixture_run_configs()
    d = p_disc.DCDiscriminator(dcfg)
    opt = RMSprop(d.parameters(), hp.lr_d)
    nu = tree["d_opt"][0]["nu"]
    with pytest.raises(ValueError, match="leaves"):
        rmsprop_state(opt, d, [{"nu": dict(nu, extra={"w": np.zeros(2)})}],
                      jax_dc_disc_params_to_state_dict, "d_opt")
    with pytest.raises(ValueError, match="another optimizer"):
        rmsprop_state(opt, d, [{"count": np.zeros(()), "mu": nu, "nu": nu}],
                      jax_dc_disc_params_to_state_dict, "d_opt")
    with pytest.raises(KeyError):
        rmsprop_state(opt, d, [{"nu": dict(nu, blocks=nu["blocks"][:-1],
                                           extra={"w": np.zeros(2)})}],
                      jax_dc_disc_params_to_state_dict, "d_opt")


def _fixture_first_batch():
    """The batch of the first iteration after a resume: the loader starts
    again from the seed (0), in JAX's loop and the port's."""
    cfg = load_config(str(FIXTURE / "jax_giraffe.yaml"), p_default())
    ds = ImagesDataset(cfg["data"]["path"], size=32)
    return next(iter(ImagesLoader(ds, 2, seed=0)))


def test_iteration_5_from_the_imported_fixture_equals_jax_s(imported_fixture, monkeypatch):
    """JAX's loop resumed at it 4 takes its D and G steps (real RMSprop, the
    EMA) on keys split from the seed's key and on the loader's first batch;
    the port's steps on the imported state and on JAX's draws give the same
    losses (1e-4 relative) and each tensor's update (new - old) within 1e-3
    of that update's norm."""
    monkeypatch.chdir(REPO)
    jcfg, (gcfg, dcfg, hp, _) = _fixture_run_configs()
    jd = j_disc.DCDiscConfig(n_feat=dcfg.n_feat, img_size=dcfg.img_size)
    jhp = j_trainer.GiraffeTrainHParams(batch_size=2)
    tree = read_export(str(FIXTURE / "run" / "model.npz"))
    as_j = functools.partial(jax.tree_util.tree_map, jnp.asarray)
    g_tx, d_tx = j_trainer.giraffe_optimizers(jhp)
    g_state = g_tx.init(as_j(tree["g"]))
    g_state = (g_state[0]._replace(nu=as_j(tree["g_opt"][0]["nu"])),) + tuple(g_state[1:])
    d_state = d_tx.init(as_j(tree["d"]))
    d_state = (d_state[0]._replace(nu=as_j(tree["d_opt"][0]["nu"])),) + tuple(d_state[1:])
    _, k1, k2, _ = jax.random.split(jax.random.PRNGKey(0), 4)
    x_real = _fixture_first_batch()
    d_step = _jit(j_trainer.make_giraffe_d_step(jcfg, jd, jhp, d_tx))
    g_step = _jit(j_trainer.make_giraffe_g_step(jcfg, jd, jhp, g_tx))
    jd_new, _, jdm = d_step(as_j(tree["g"]), as_j(tree["d"]), d_state, k1, x_real)
    jg_new, _, jema_new, jgm = g_step(as_j(tree["g"]), jd_new, g_state, as_j(tree["g_ema"]), k2)

    state = checkpoints.load_checkpoint(str(imported_fixture), "model")
    g, d, g_ema = (p_gen.GiraffeGenerator(gcfg), p_disc.DCDiscriminator(dcfg),
                   p_gen.GiraffeGenerator(gcfg))
    for m, k in ((g, "g"), (d, "d"), (g_ema, "g_ema")):
        m.load_state_dict(state[k])
    g_opt, d_opt = giraffe_optimizers(hp, g, d)
    g_opt.load_state_dict(state["g_opt"])
    d_opt.load_state_dict(state["d_opt"])
    old = {k: {n: v.clone() for n, v in m.state_dict().items()}
           for k, m in (("g", g), ("d", d), ("g_ema", g_ema))}
    dm = p_trainer.giraffe_d_step(g, d, d_opt, gcfg, hp, T(x_real), _jax_draws(k1, jcfg, 2))
    gm = p_trainer.giraffe_g_step(g, d, g_opt, g_ema, gcfg, hp, _jax_draws(k2, jcfg, 2))
    for k in ("discriminator", "regularizer"):
        _close_loss(dm[k], jdm[k])
    _close_loss(gm["generator"], jgm["generator"])
    new_j = {"d": _named(jax_dc_disc_params_to_state_dict, jd_new),
             "g": _named(jax_giraffe_params_to_state_dict, jg_new, gcfg),
             "g_ema": _named(jax_giraffe_params_to_state_dict, jema_new, gcfg)}
    for k, m in (("g", g), ("d", d), ("g_ema", g_ema)):
        got = {n: v - old[k][n] for n, v in m.state_dict().items()}
        _close_grads(got, {n: v - old[k][n] for n, v in new_j[k].items()})


# ------------------------------------------------------------------ the CLI
def _write_yaml(ws, name, extra=""):
    """The fixture's yaml with 8 samples per ray, not 64 (the parameters are
    the fixture's; only the render is cheaper), its out_dir under ``ws``."""
    text = (f"inherit_from: {FIXTURE / 'jax_giraffe.yaml'}\n"
            "model:\n  generator_kwargs:\n    n_ray_samples: 8\n"
            f"training:\n  out_dir: out/{name}\n{extra}")
    (ws / f"{name}.yaml").write_text(text)
    return f"{name}.yaml"


def _rows(path):
    return [json.loads(line) for line in open(path)]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """One workspace, three CLI runs: ``--vae 1 --exit-after 1`` (exit 3
    after its first iteration), the same again (resumed, to ``max_it`` 4,
    with an FID at ``validate_every`` 4 against random statistics), and the
    imported fixture resumed at it 5 to ``max_it`` 6."""
    ws = tmp_path_factory.mktemp("cli")
    os.symlink(REPO / "tests", ws / "tests")
    acts = np.abs(_rng(8).standard_normal((6, 2048)))
    np.savez(ws / "stats.npz", mu=acts.mean(0), sigma=np.cov(acts, rowvar=False), img_size=32)
    cwd = os.getcwd()
    os.chdir(ws)
    try:
        config = _write_yaml(ws, "run", "  validate_every: 4\n  n_eval_images: 4\n"
                             "data:\n  fid_file: stats.npz\n")
        flags = ["--config", config, *FIXTURE_FLAGS, "--vae", "1", "--device", "cpu"]
        with pytest.raises(SystemExit) as cut:
            train_cli.main(flags + ["--exit-after", "1"])
        cut_state = checkpoints.load_checkpoint("out/run", "model")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            train_cli.main(flags)
        resumed = _write_yaml(ws, "jax_giraffe", "  max_it: 6\n")
        checkpoints.import_jax_run(str(FIXTURE / "run"), "out/jax_giraffe",
                                   giraffe_run_configs(load_config(resumed, p_default()),
                                                       train_cli.parse_args(FIXTURE_FLAGS)))
        train_cli.main(["--config", resumed, *FIXTURE_FLAGS, "--device", "cpu"])
    finally:
        os.chdir(cwd)
    return ws, cut.value.code, cut_state, printed.getvalue()


def test_cli_writes_resumes_and_exits_3(cli_runs):
    """The cut run saves ``model`` and ``encoder`` and exits 3; the next run
    resumes at it + 1 and writes ``model``, the backups ``model_0000002`` /
    ``model_0000004``, ``encoder`` and a metrics line per iteration."""
    ws, code, cut_state, resumed = cli_runs
    out = ws / "out" / "run"
    assert code == 3 and cut_state["it"] >= 1
    assert f"resumed GIRAFFE from iteration {cut_state['it']}" in resumed
    assert "resumed VAE encoder" in resumed
    names = sorted(os.listdir(out))
    for n in ("model.pt", "model_0000004.pt", "encoder.pt", "giraffe_metrics.jsonl",
              "model_best.pt"):
        assert n in names
    assert "model_0000002.pt" in names
    rows = [r for r in _rows(out / "giraffe_metrics.jsonl") if "generator" in r]
    assert [r["step"] for r in rows] == list(range(1, 5))
    for r in rows:
        assert all(np.isfinite(r[k]) for k in ("discriminator", "regularizer", "generator",
                                               "encoder", "e_kl"))
    state = checkpoints.load_checkpoint(str(out), "model")
    assert state["it"] == 4 and set(state) == {"g", "d", "g_ema", "g_opt", "d_opt", "it",
                                               "fid_best"}
    assert set(checkpoints.load_checkpoint(str(out), "encoder")) == {"e", "e_opt"}


def test_cli_keeps_the_best_fid_model(cli_runs):
    ws = cli_runs[0]
    out = ws / "out" / "run"
    fid = [r for r in _rows(out / "giraffe_metrics.jsonl") if "fid_score" in r]
    assert [r["step"] for r in fid] == [4] and np.isfinite(fid[0]["fid_score"])
    best = checkpoints.load_checkpoint(str(out), "model_best")
    assert best["it"] == 4 and best["fid_best"] == pytest.approx(fid[0]["fid_score"])
    # ``model`` at it 4 is saved before that iteration's FID (JAX's order),
    # unless the cut run reached it 4 and saved it again on exit
    assert checkpoints.load_checkpoint(str(out), "model")["fid_best"] in (float("inf"),
                                                                          best["fid_best"])


def test_cli_resumes_the_imported_jax_run(cli_runs):
    """The fixture imported (it 4) trains it 5 and 6 and saves at 6."""
    ws = cli_runs[0]
    out = ws / "out" / "jax_giraffe"
    rows = [r for r in _rows(out / "giraffe_metrics.jsonl") if "generator" in r]
    assert [r["step"] for r in rows] == [5, 6]
    assert checkpoints.load_checkpoint(str(out), "model_0000006")["it"] == 6


def test_cli_without_a_card_raises(tmp_path, monkeypatch):
    """``--sdf 0`` without ``--device cpu`` on a machine with no card raises
    before anything is written."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(tmp_path)
    config = _write_yaml(tmp_path, "nocard")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--config", config, *FIXTURE_FLAGS])
    assert not (tmp_path / "out").exists()


# ---------------------------------------------------------- the 64^2 recipe
def _recipe_script():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_giraffe_run", REPO / "scripts" / "torch_giraffe_run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_recipe_script_windows_jax_s_curve_and_imports_no_jax():
    """``scripts/torch_giraffe_run.py``'s 2,000-iteration windows of JAX's
    own metrics file give the medians and ranges the JAX run is known by
    (D 1.276 (0.955-1.327), G 0.700 (0.587-1.056), R1 0.052 (0.036-0.145)
    over iterations 1-2,000; R1 0.015 (0.011-0.020) over 8,001-10,000), and
    the script imports neither JAX nor the JAX package."""
    import ast

    script = _recipe_script()
    wins = script.windows(script.rows(str(REPO / script.JAX_METRICS)), 10001)
    assert [w["iterations"] for w in wins] == [[1, 2000], [2001, 4000], [4001, 6000],
                                               [6001, 8000], [8001, 10000]]
    first, last = wins[0], wins[-1]
    for key, (med, lo, hi) in (("discriminator", (1.276, 0.955, 1.327)),
                               ("generator", (0.700, 0.587, 1.056)),
                               ("regularizer", (0.052, 0.036, 0.145))):
        assert [round(first[key][k], 3) for k in ("median", "min", "max")] == [med, lo, hi]
    assert [round(last["regularizer"][k], 3) for k in ("median", "min", "max")] == [
        0.015, 0.011, 0.020]
    for node in ast.walk(ast.parse((REPO / "scripts" / "torch_giraffe_run.py").read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""])
            assert not any(n.split(".")[0] in ("jax", "optax", "yaml", "PIL")
                           or n == "sdface_gan_tpu" or n.startswith("sdface_gan_tpu.")
                           for n in names), names
