"""The port's data parallelism (``sdface_gan_tpu_torch/parallel/``) against
JAX's multi-device mesh, on the CPU.

The port's ranks are gloo process groups of JAX-free processes
(``torch_parallel_ranks.spawn``); JAX's side is its global program,
``data_parallel_jit`` on a mesh of the conftest's virtual CPU devices, on
the same inputs.  Each W-rank step is held three ways: against JAX's mesh
step at the tolerances of the existing parity tests (losses rtol 1e-4, a
gradient's difference within ``GRAD_RTOL`` of its norm), against the port's
one-rank step at the same global batch (``SAME_RTOL`` of the norm), and
across the ranks (the parameters after one Adam step bit-equal).  Where a
sample's result depends on the rest of the batch (the StyleGAN D's
minibatch stddev, the VAE's batch statistics, the path-length mean), a
negative control runs the naive per-rank version and must miss JAX's
gradients by more than ten times the bar.  Global batch 8 (stage B's D also
on 4 ranks); widths as in ``test_torch_port_training.py``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdface_gan_tpu import parallel as j_par  # noqa: E402
from sdface_gan_tpu.encoder import vae as j_vae  # noqa: E402
from sdface_gan_tpu.encoder import losses as j_losses  # noqa: E402
from sdface_gan_tpu.geometry import generate_camera_params as j_cams  # noqa: E402
from sdface_gan_tpu.giraffe import trainer as j_trainer  # noqa: E402
from sdface_gan_tpu.losses import gan_losses as j_gan  # noqa: E402
from sdface_gan_tpu.models import discriminator as j_disc  # noqa: E402
from sdface_gan_tpu.models import generator as j_gen  # noqa: E402
from sdface_gan_tpu.models import renderer as j_rend  # noqa: E402
from sdface_gan_tpu.models import stylegan2 as j_sg  # noqa: E402
from sdface_gan_tpu.serving import SDFaceSampler as JSampler  # noqa: E402
from sdface_gan_tpu.training import steps as j_steps  # noqa: E402
from sdface_gan_tpu_torch import encoder  # noqa: E402
from sdface_gan_tpu_torch.geometry import CameraParams  # noqa: E402
from sdface_gan_tpu_torch.giraffe import discriminator as p_disc  # noqa: E402
from sdface_gan_tpu_torch.giraffe import trainer as p_trainer  # noqa: E402
from sdface_gan_tpu_torch.models import discriminator, generator  # noqa: E402
from sdface_gan_tpu_torch.parallel import Mesh, all_reduce_grads, shard_batch  # noqa: E402
from sdface_gan_tpu_torch.training import encoder_loop, loop, steps  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import (  # noqa: E402
    jax_dc_disc_params_to_state_dict,
    jax_disc_params_to_state_dict,
    jax_giraffe_params_to_state_dict,
    jax_params_to_state_dict,
    jax_vae_params_to_state_dict,
)

import torch_parallel_ranks as ranks  # noqa: E402
from test_torch_port_giraffe import _jax_tree, _models  # noqa: E402
from test_torch_port_giraffe_training import (  # noqa: E402
    _capture_tx,
    _jax_draws,
    _step_cfgs,
)
from test_torch_port_training import (  # noqa: E402,F401  (_two_threads: autouse)
    _configs_a,
    _configs_b,
    _two_threads,
)

GLOBAL = 8
STYLE, RES = 16, 8
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-4, 1e-6
G_GRAD_RTOL = 1e-3  # generator and encoder gradients, as in the existing parity tests
SAME_RTOL = 1e-5  # a W-rank step against the port's one-rank step, of the norm
NAIVE_FACTOR = 10.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _jit(fn, **kw):
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0,
                                         "xla_llvm_disable_expensive_passes": True}, **kw)


def _dp_jit(fn, world, batch_argnums):
    """JAX's global program over a ``world``-device mesh, as its loops jit it."""
    return j_par.data_parallel_jit(fn, j_par.make_mesh(jax.devices()[:world]),
                                   batch_argnums=batch_argnums)


def _rng(seed):
    return np.random.default_rng(seed)


def _uniform(seed, *shape):
    return _rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _z(seed, n=GLOBAL):
    return _rng(seed).standard_normal((n, STYLE)).astype(np.float32)


def _cams(seed, n=GLOBAL, res=RES):
    jc = j_cams(res, jax.random.PRNGKey(seed), batch=n)
    return jc, CameraParams(*[_t(x) for x in jc])


def _worst(got, want):
    """The largest ``||g - w|| / (||w|| + atol / rtol)`` ratio terms: returns
    the worst ``err / scale`` and checks names."""
    assert set(got) == set(want), set(got) ^ set(want)
    return max((got[k] - want[k]).norm().item() / (want[k].norm().item() + 1e-30)
               for k in want)


def _close(got, want, rtol, atol=GRAD_ATOL):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        err, scale = (got[k] - w).norm().item(), w.norm().item()
        assert err <= rtol * scale + atol, (k, err, scale)


def _mean_metrics(results, name, key="metrics"):
    keys = results[0][name][key]
    return {k: float(np.mean([r[name][key][k] for r in results])) for k in keys}


# ---------------------------------------------------------------------------
# The cases: port payloads and their JAX references at the global batch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sdf_setup():
    ja, pa = _configs_a()
    jb, pb = _configs_b()
    dcfg_a = (j_disc.VolumeRenderDiscConfig(in_res=RES),
              discriminator.VolumeRenderDiscConfig(in_res=RES))
    dkw = dict(size=32, channel_multiplier=1, channel_base=16)
    dcfg_b = j_disc.StyleDiscConfig(**dkw), discriminator.StyleDiscConfig(**dkw)
    return dict(
        a=(ja, pa, _init(j_gen.init_generator, 0, ja), dcfg_a,
           _init(j_disc.init_volume_render_discriminator, 5, dcfg_a[0])),
        b=(jb, pb, _init(j_gen.init_generator, 20, jb), dcfg_b,
           _init(j_disc.init_style_discriminator, 21, dcfg_b[0])))


def _init(fn, seed, cfg):
    """A JAX initializer, jitted (eagerly it compiles every operation apart)."""
    return jax.tree_util.tree_map(np.asarray, _jit(fn, static_argnums=1)(
        jax.random.PRNGKey(seed), cfg))


HP = steps.TrainHParams(batch=GLOBAL, style_dim=STYLE)
J_HP = j_steps.TrainHParams(batch=GLOBAL, style_dim=STYLE)
IDX = 3
PATH = GLOBAL // 2
MEAN0 = np.float32(0.3)


def _sdf_case(kind):
    stage = kind[0]
    jcfg, pcfg, params, dcfgs, dparams = _sdf_setup()[stage]
    case = dict(kind=kind, hp=HP, gcfg=pcfg, dcfg=dcfgs[1],
                g=jax_params_to_state_dict(params, pcfg),
                d=jax_disc_params_to_state_dict(dparams))
    n = PATH if kind == "b_path" else GLOBAL
    _, pc = _cams(1, n)
    z1, z2 = _z(2, n), _z(3, n)
    if stage == "a":
        case["inputs"] = steps.StepInputs(_t(z1), pc)
        case["real"] = _t(_uniform(4, GLOBAL, RES, RES, 3))
    else:
        case["inputs"] = steps.StepInputs(_t(z1), pc, _t(z2), IDX)
        case["real"] = _t(_uniform(4, GLOBAL, 32, 32, 3))
    if kind == "b_path":
        noise = (_rng(5).standard_normal((PATH, 32, 32, 3)) / 32.0).astype(np.float32)
        case["inputs"] = case["inputs"]._replace(path_noise=_t(noise))
        case["mean_path_length"] = torch.tensor(MEAN0)
    return case


def _sdf_jax(kind, world):
    """(loss, {port name: JAX gradient}) of JAX's global program for ``kind``
    over a ``world``-device mesh."""
    stage = kind[0]
    jcfg, pcfg, params, (dcfg, _), dparams = _sdf_setup()[stage]
    n = PATH if kind == "b_path" else GLOBAL
    jc, _ = _cams(1, n)
    z1, z2 = jnp.asarray(_z(2, n)), jnp.asarray(_z(3, n))
    d_apply = (j_disc.apply_volume_render_discriminator if stage == "a"
               else j_disc.apply_style_discriminator)
    if kind in ("a_d", "b_d"):
        styles = [z1] if stage == "a" else [z1, z2]
        out = _jit(lambda p, zs, c: j_gen.generator_forward(
            p, jcfg, zs, c.extrinsics, c.focal, c.near, c.far,
            inject_index=None if stage == "a" else IDX))(params, styles, jc)
        fake = out.thumb_rgb if stage == "a" else out.rgb
        real = jnp.asarray(_uniform(4, GLOBAL, *((RES, RES) if stage == "a" else (32, 32)), 3))

        def loss(dp, real, fake, view):
            if stage == "a":
                apply = lambda img: d_apply(dp, dcfg, img)[0]  # noqa: E731
                fake_pred, fake_view = d_apply(dp, dcfg, fake)
                extra = J_HP.view_lambda * j_gan.viewpoints_loss(fake_view, view)
                scale = J_HP.r1 * 0.5
            else:
                apply = lambda img: d_apply(dp, dcfg, img)  # noqa: E731
                fake_pred, extra = apply(fake), 0.0
                scale = J_HP.r1 * 0.5 * J_HP.d_reg_every
            real_pred, pen = j_gan.d_logits_and_r1(apply, real)
            return j_gan.d_logistic_loss(real_pred, fake_pred) + scale * pen + extra

        val, grads = _dp_jit(jax.value_and_grad(loss), world, (1, 2, 3))(
            dparams, real, fake, jc.viewpoint)
        return float(val), jax_disc_params_to_state_dict(grads)
    if kind == "a_g":
        def loss(gp, z, c):
            out = j_gen.generator_forward(gp, jcfg, [z], c.extrinsics, c.focal, c.near, c.far,
                                          return_sdf=True, return_xyz=True,
                                          return_eikonal=True)
            fake_pred, fake_view = d_apply(dparams, dcfg, out.thumb_rgb)
            eik, msurf = j_geo_eikonal(out)
            return (j_gan.g_nonsaturating_loss(fake_pred)
                    + J_HP.view_lambda * j_gan.viewpoints_loss(fake_view, c.viewpoint)
                    + J_HP.eikonal_lambda * eik + J_HP.min_surf_lambda * msurf)

        val, grads = _dp_jit(jax.value_and_grad(loss), world, (1, 2))(params, z1, jc)
        return float(val), jax_params_to_state_dict(grads, pcfg)
    if kind == "b_g":
        def loss(gp, z1, z2, c):
            out = j_gen.generator_forward(gp, jcfg, [z1, z2], c.extrinsics, c.focal, c.near,
                                          c.far, inject_index=IDX)
            up = jnp.repeat(jnp.repeat(out.thumb_rgb, 4, axis=1), 4, axis=2)
            return (j_gan.g_nonsaturating_loss(d_apply(dparams, dcfg, out.rgb))
                    + 0.001 * j_gan.g_content_loss(out.rgb, up))

        val, grads = _dp_jit(jax.value_and_grad(loss), world, (1, 2, 3))(params, z1, z2, jc)
        return float(val), _decoder_grads(grads, pcfg)
    # b_path: the decoder's path-length penalty on the frozen renderer's features
    noise = jnp.asarray((_rng(5).standard_normal((PATH, 32, 32, 3)) / 32.0).astype(np.float32))

    def loss(gp, z1, z2, c, noise):
        feats = jax.lax.stop_gradient(j_rend.render(
            gp["renderer"], jcfg.renderer, c.focal, c.extrinsics, c.near, c.far,
            j_gen.map_style(gp, z1)).features)
        latent = j_sg.make_decoder_latent(gp["decoder"], jcfg.decoder,
                                          [j_gen.map_style(gp, z1), j_gen.map_style(gp, z2)],
                                          inject_index=IDX)
        pen, new_mean, _ = j_gan.g_path_regularize(
            lambda lat: j_sg.apply_decoder(gp["decoder"], jcfg.decoder, feats, lat), latent,
            jnp.asarray(MEAN0), noise=noise)
        return J_HP.path_regularize * J_HP.g_reg_every * pen, new_mean

    (val, new_mean), grads = _dp_jit(jax.value_and_grad(loss, has_aux=True), world,
                                     (1, 2, 3, 4))(params, z1, z2, jc, noise)
    return float(val), {**_decoder_grads(grads, pcfg), "mean_path_length": float(new_mean)}


def j_geo_eikonal(out):
    from sdface_gan_tpu.losses import geometry_losses as j_geo

    return j_geo.eikonal_loss(out.eikonal_term, out.sdf, beta=J_HP.min_surf_beta)


def _decoder_grads(grads, pcfg):
    """The decoder's parameters' gradients (JAX's tree also holds the stored
    noise, a buffer in the port)."""
    return {k: v for k, v in jax_params_to_state_dict(grads, pcfg).items()
            if k.startswith("decoder.") and ".noises." not in k}


@functools.lru_cache(maxsize=None)
def _vae_setup():
    from test_torch_port_stage_c import _gcfgs

    jcfg, pcfg = _gcfgs(16, 16)
    gp = _init(j_gen.init_generator, 1, jcfg)
    g = generator.Generator(pcfg, device="cpu")
    g.load_state_dict(jax_params_to_state_dict(gp, pcfg))
    jecfg = j_vae.VAEEncoderConfig(img_size=16, z_size=16)
    return jcfg, pcfg, gp, g, jecfg, _init(j_vae.init_vae_encoder, 2, jecfg)


def _vae_inputs():
    imgs, thumbs = _uniform(6, GLOBAL, 16, 16, 3), _uniform(7, GLOBAL, 8, 8, 3)
    eps = _rng(8).standard_normal((GLOBAL, 16)).astype(np.float32)
    jc, pc = _cams(9)
    return imgs, thumbs, eps, jc, pc


def _vae_case():
    jcfg, pcfg, gp, g, jecfg, ep = _vae_setup()
    imgs, thumbs, eps, _, pc = _vae_inputs()
    return dict(kind="vae_e", gcfg=pcfg, g=g.state_dict(),
                ecfg=encoder.VAEEncoderConfig(img_size=16, z_size=16),
                e=jax_vae_params_to_state_dict(ep),
                inputs=encoder_loop.EncoderInputs(_t(imgs), _t(thumbs), pc, eps=_t(eps)))


def _vae_jax(world):
    from sdface_gan_tpu.training import encoder_loop as j_loop

    jcfg, pcfg, gp, g, jecfg, ep = _vae_setup()
    imgs, thumbs, eps, jc, _ = _vae_inputs()

    def loss(ep, imgs, thumbs, c, eps):
        mu, logvar = j_vae.apply_vae_encoder(ep, jecfg, imgs)
        out = j_gen.generator_forward(gp, jcfg, [mu + jnp.exp(0.5 * logvar) * eps],
                                      c.extrinsics, c.focal, c.near, c.far, key=None)
        thumb = j_loop.THUMB_LOSS(out.thumb_rgb, thumbs)
        full = j_losses.LossUtils()(out.rgb, imgs)
        return 0.5 * thumb["loss"] + 0.5 * full["loss"] + 0.005 * j_vae.kl_divergence(mu, logvar)

    val, grads = _dp_jit(jax.value_and_grad(loss), world, (1, 2, 3, 4))(
        ep, jnp.asarray(imgs), jnp.asarray(thumbs), jc, jnp.asarray(eps))
    return float(val), jax_vae_params_to_state_dict(grads)


G_KEY = {"giraffe_d": 31, "giraffe_g": 32, "giraffe_e": 33}


@functools.lru_cache(maxsize=None)
def _giraffe_setup():
    import dataclasses

    (jcfg, jd, jhp), (pcfg, pd, php) = _step_cfgs("normal")
    gparams, g = _models(jcfg, pcfg)
    d = p_disc.DCDiscriminator(pd, torch.Generator().manual_seed(5))
    jhp = dataclasses.replace(jhp, batch_size=GLOBAL)
    php = dataclasses.replace(php, batch_size=GLOBAL)
    ecfg = p_trainer.encoder_config(pcfg, pd.img_size)
    jecfg = j_vae.VAEEncoderConfig(img_size=pd.img_size, z_size=2 * jcfg.z_dim)
    eparams = _init(j_vae.init_vae_encoder, 3, jecfg)
    real = _rng(34).random((GLOBAL, pd.img_size, pd.img_size, 3), dtype=np.float32)
    return dict(jcfg=jcfg, jd=jd, jhp=jhp, pcfg=pcfg, pd=pd, php=php, gparams=gparams, g=g,
                d=d, dparams=_jax_tree(d.state_dict()), ecfg=ecfg, eparams=eparams, real=real)


def _giraffe_case(kind):
    s = _giraffe_setup()
    key = jax.random.PRNGKey(G_KEY[kind])
    case = dict(kind=kind, gcfg=s["pcfg"], dcfg=s["pd"], hp=s["php"], g=s["g"].state_dict(),
                d=s["d"].state_dict(), real=_t(s["real"]))
    if kind == "giraffe_e":
        kz, kg = jax.random.split(key)
        eps = _t(jax.random.normal(kz, (GLOBAL, 2 * s["jcfg"].z_dim)))
        case["draws"] = p_trainer.EncoderDraws(eps, _jax_draws(
            kg, s["jcfg"], GLOBAL, codes_key=jax.random.split(kg, 1)[0]))
        case.update(ecfg=s["ecfg"], e=jax_vae_params_to_state_dict(s["eparams"]))
    else:
        case["draws"] = _jax_draws(key, s["jcfg"], GLOBAL)
    return case


def _giraffe_jax(kind, world):
    s = _giraffe_setup()
    key = jax.random.PRNGKey(G_KEY[kind])
    tx = _capture_tx()
    if kind == "giraffe_d":
        step = _dp_jit(j_trainer.make_giraffe_d_step(s["jcfg"], s["jd"], s["jhp"], tx), world,
                       (4,))
        _, grads, m = step(s["gparams"], s["dparams"], tx.init(s["dparams"]), key, s["real"])
        return float(m["discriminator"] + m["regularizer"]), \
            jax_dc_disc_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))
    if kind == "giraffe_g":
        step = _dp_jit(j_trainer.make_giraffe_g_step(s["jcfg"], s["jd"], s["jhp"], tx), world, ())
        _, grads, _, m = step(s["gparams"], s["dparams"], tx.init(s["gparams"]), s["gparams"],
                              key)
        return float(m["generator"]), jax_giraffe_params_to_state_dict(
            jax.tree_util.tree_map(np.asarray, grads), s["pcfg"])
    step = _dp_jit(j_trainer.make_giraffe_encoder_step(s["jcfg"], s["jd"], s["jhp"], tx), world,
                   (5,))
    _, grads, m = step(s["eparams"], s["gparams"], s["dparams"], tx.init(s["eparams"]), key,
                       s["real"])
    return float(m["encoder"]), jax_vae_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, grads))


def _case(name):
    if name == "vae_e":
        return _vae_case()
    if name.startswith("giraffe"):
        return _giraffe_case(name)
    return _sdf_case(name)


@functools.lru_cache(maxsize=None)
def _jax_ref_cached(name, world):
    if name == "vae_e":
        return _vae_jax(world)
    if name.startswith("giraffe"):
        return _giraffe_jax(name, world)
    return _sdf_jax(name, world)


def _jax_ref(name, world=2):
    """(loss, {port name: gradient}) of JAX's ``world``-device program (a
    fresh dict of the cached one)."""
    loss, grads = _jax_ref_cached(name, world)
    return loss, dict(grads)


# the loss each case's metrics add up to, as JAX returns it
LOSS_OF = {"a_d": ("d", "r1", "d_view"), "a_g": ("g", "g_view", "g_eikonal", "g_minimal_surface"),
           "b_d": ("d", "r1"), "b_g": None, "b_path": None, "vae_e": ("e_loss",),
           "giraffe_d": ("discriminator", "regularizer"), "giraffe_g": ("generator",),
           "giraffe_e": ("encoder",)}
NAIVE = ("b_d", "b_path", "vae_e", "giraffe_e")  # the couplings 1-3
CASES = ("a_d", "a_g", "b_d", "b_g", "b_path", "vae_e", "giraffe_d", "giraffe_g", "giraffe_e")
TOLS = {"a_d": GRAD_RTOL, "b_d": GRAD_RTOL, "giraffe_d": G_GRAD_RTOL}


@pytest.fixture(scope="module")
def spawned():
    """Every rank job of this file, started at once: one 2-rank spawn (every
    step case, the mesh's pieces, serving) and stage B's D on 4 ranks; while
    they run, this process takes the one-rank steps at the global batch and
    JAX's mesh steps."""
    cases = {"cases": {n: dict(_case(n), naive=n in NAIVE) for n in CASES}}
    two = ranks.start("group", 2, {"cases": cases, "basics": {}, "serving": _serving_payload()})
    four = ranks.start("cases", 4, {"cases": {"b_d": dict(_case("b_d"), naive=True)}})
    try:
        one = ranks.run_cases(None, cases)
        for name, world in [(n, 2) for n in CASES] + [("b_d", 4)]:
            _jax_ref_cached(name, world)
    finally:
        res2, res4 = two.result(), four.result()
    return {"two": [r["cases"] for r in res2], "four": res4, "one": one,
            "basics": [r["basics"] for r in res2], "serving": [r["serving"] for r in res2]}


@pytest.fixture(scope="module")
def two_ranks(spawned):
    """Every case on 2 gloo ranks and on one rank at the global batch."""
    return spawned["two"], spawned["one"]


@pytest.fixture(scope="module")
def four_ranks(spawned):
    return spawned["four"], spawned["one"]


def _check_case(results, one, name, world):
    tol = TOLS.get(name, G_GRAD_RTOL)
    jl, jg = _jax_ref(name, world)
    grads = [r[name]["grads"] for r in results]
    for g in grads[1:]:  # the all-reduce leaves every rank the same bits
        assert all(torch.equal(g[k], grads[0][k]) for k in g)
    jmean = jg.pop("mean_path_length", None)
    _close(grads[0], {k: _t(v) if not torch.is_tensor(v) else v for k, v in jg.items()}, tol)
    _close(grads[0], one[name]["grads"], SAME_RTOL, 1e-9)
    # the parameters after one Adam step, equal on every rank
    params = [r[name]["params"] for r in results]
    assert all(torch.equal(p[k], params[0][k]) for p in params[1:] for k in p)
    metrics = _mean_metrics(results, name)
    for k, v in one[name]["metrics"].items():
        np.testing.assert_allclose(metrics[k], v, rtol=SAME_RTOL, atol=1e-7, err_msg=k)
    keys = LOSS_OF[name]
    if keys:
        np.testing.assert_allclose(sum(metrics[k] for k in keys), jl, rtol=LOSS_RTOL)
    if jmean is not None:  # the path-length mean: the global batch's, on every rank
        assert len({r[name]["metrics"]["mean_path_length"] for r in results}) == 1
        np.testing.assert_allclose(metrics["mean_path_length"], jmean, rtol=1e-5)
    return jg, tol


@pytest.mark.parametrize("name", CASES)
def test_two_rank_step_matches_jax_mesh_and_one_rank(two_ranks, name):
    """Stage A's D (R1) and G (eikonal), stage B's D (R1 through the
    minibatch stddev), G and path steps, stage C's VAE E step and GIRAFFE's
    D, G and E steps on 2 ranks at global batch 8."""
    results, one = two_ranks
    _check_case(results, one, name, 2)


@pytest.mark.parametrize("name", NAIVE)
def test_naive_per_rank_statistics_miss_jax(two_ranks, name):
    """The negative control of couplings 1-3: the same step with each rank's
    own statistics misses JAX's mesh gradients by > 10x the bar."""
    results, _ = two_ranks
    _, jg = _jax_ref(name, 2)
    jmean = jg.pop("mean_path_length", None)
    if jmean is not None:  # coupling 3 moves the running mean, which each rank keeps
        for r in results:
            assert abs(r[name]["metrics"]["mean_path_length"] / jmean - 1) < 1e-5
            assert abs(r[name]["naive_metrics"]["mean_path_length"] / jmean - 1) > \
                NAIVE_FACTOR * 1e-5
        return
    jg = {k: _t(v) if not torch.is_tensor(v) else v for k, v in jg.items()}
    tol = TOLS.get(name, G_GRAD_RTOL)
    assert _worst(results[0][name]["grads"], jg) < tol
    assert _worst(results[0][name]["naive_grads"], jg) > NAIVE_FACTOR * tol


def test_four_rank_stage_b_d_step_matches_jax_mesh(four_ranks):
    """Stage B's D with R1 at local batch 2: the stddev groups of 4 span all
    four ranks; the naive version's groups of 2 do not."""
    results, one = four_ranks
    jg, tol = _check_case(results, one, "b_d", 4)
    jg = {k: _t(v) if not torch.is_tensor(v) else v for k, v in jg.items()}
    assert _worst(results[0]["b_d"]["naive_grads"], jg) > NAIVE_FACTOR * tol


# ---------------------------------------------------------------------------
# The mesh's own pieces
# ---------------------------------------------------------------------------

def test_world_of_one_is_the_single_process_program():
    mesh = Mesh()
    x = torch.arange(6.0).reshape(3, 2)
    assert shard_batch(x, mesh) is x and shard_batch(x, None) is x
    grads = [torch.ones(2), torch.ones(3, dtype=torch.float64)]
    assert all(a is b for a, b in zip(all_reduce_grads(grads, mesh), grads))
    assert loop.training_mesh(8, None, torch.device("cpu")).world == 1


def test_make_mesh_refuses_a_world_without_its_launcher(monkeypatch):
    from sdface_gan_tpu_torch.parallel import make_mesh

    for k in ("RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="refusing to run as one rank"):
        make_mesh("cpu")


def test_a_world_that_does_not_divide_the_batch_raises():
    mesh = Mesh(rank=0, world=3, group=object())
    with pytest.raises(ValueError, match="global batch 8 must divide across the 3-rank world"):
        loop.training_mesh(8, mesh, torch.device("cpu"))
    with pytest.raises(ValueError, match="8 must divide"):
        shard_batch(torch.zeros(8), mesh)


def test_shard_replicate_reduce_and_the_double_backward_of_the_gather(spawned):
    """``shard_batch`` (tensors, named tuples, 0-d and None kept whole),
    ``replicate`` (modules and optimizer state), ``all_reduce_grads`` (mean
    and sum, two dtypes) and ``all_gather_batch`` differentiated twice,
    against the same sums over the global tensors."""
    res = spawned["basics"]
    x = torch.arange(8 * 3, dtype=torch.float64).reshape(8, 3)
    for r, out in enumerate(res):
        assert torch.equal(out["rows"], x[4 * r:4 * (r + 1)])
        assert out["tuple_kept"]
        assert torch.equal(out["module"], res[0]["module"])
        assert torch.equal(out["opt_state"], res[0]["opt_state"])
        assert torch.equal(out["mean"][0], torch.full((3,), 1.5))
        assert torch.equal(out["mean"][1], torch.full((2,), 1.5, dtype=torch.float64))
        assert torch.equal(out["sum"][0], torch.full((3,), 3.0))
    xg = torch.cat([o["x"] for o in res])  # the global batch [4, 3]
    c = sum(o["c"] for o in res)
    v = torch.cat([o["v"] for o in res])
    for r, out in enumerate(res):
        rows = slice(2 * r, 2 * (r + 1))
        torch.testing.assert_close(out["grad1"], (3 * c * xg ** 2)[rows], rtol=1e-12, atol=0)
        torch.testing.assert_close(out["grad2"], (6 * c * xg * v)[rows], rtol=1e-12, atol=0)
        torch.testing.assert_close(out["gathered"], xg, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Serving: the ray-sharded render and the sampler
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _serving_setup():
    from dataclasses import replace

    jb, pb = _configs_b()
    params = _init(j_gen.init_generator, 40, jb)
    rcfg = dict(static_viewdirs=True, force_background=True, perturb=0.0, return_sdf=True)
    return dict(jb=jb, pb=pb, params=params, sd=jax_params_to_state_dict(params, pb),
                jr=replace(jb.renderer, **rcfg), pr=replace(pb.renderer, **rcfg),
                jfix=replace(jb, renderer=replace(jb.renderer, perturb=0.0)),
                pfix=replace(pb, renderer=replace(pb.renderer, perturb=0.0)),
                cams=_cams(41, 2), style=_z(42, 2), z=_z(43))


SAMPLE_FIXED = dict(azim=0.2, elev=-0.1)


def _serving_payload():
    """The sampler with the depth jitter on and with fixed depths, and the
    ray-sharded render (test mode)."""
    from dataclasses import replace

    s = _serving_setup()
    pc = s["cams"][1]
    return {"samplers": [dict(gcfg=s["pb"], g=s["sd"], batch=GLOBAL, sample=dict(seed=5)),
                         dict(gcfg=s["pfix"], g=s["sd"], batch=GLOBAL,
                              sample=dict(SAMPLE_FIXED, z=s["z"]), kwargs=dict(truncation=1.0))],
            "rays": dict(gcfg=replace(s["pb"], renderer=s["pr"]), g=s["sd"],
                         args=[pc.focal, pc.extrinsics, pc.near, pc.far, _t(s["style"])])}


def test_ray_sharded_render_and_sampler_over_two_ranks(spawned):
    """``render_ray_sharded`` (test mode, rows split) against the port's
    ``render`` and JAX's ``render_ray_sharded`` on a 2-device mesh;
    ``SDFaceSampler(mesh=...)`` over 2 ranks against one rank with the depth
    jitter on (drawn for the whole batch), and with fixed depths against
    JAX's sampler over its mesh on the same z at a fixed viewpoint; both
    refuse a world that does not divide."""
    from sdface_gan_tpu.parallel.rays import render_ray_sharded as j_rays
    from sdface_gan_tpu_torch.models.renderer import render
    from sdface_gan_tpu_torch.serving import SDFaceSampler

    s = _serving_setup()
    pb, params, sd, jr, pr = (s[k] for k in ("pb", "params", "sd", "jr", "pr"))
    jfix, pfix, (jc, pc), style, z = (s[k] for k in ("jfix", "pfix", "cams", "style", "z"))
    assert pb.renderer.perturb > 0
    rays_args = _serving_payload()["rays"]["args"]
    fixed = dict(SAMPLE_FIXED, z=z)
    res = spawned["serving"]
    g = generator.Generator(pb, device="cpu")
    g.load_state_dict(sd)
    with torch.inference_mode():
        ref = render(g.renderer, pr, *rays_args)
    jref = j_rays(params["renderer"], jr, jc.focal, jc.extrinsics, jc.near, jc.far,
                  jnp.asarray(style), j_par.make_mesh(jax.devices()[:2]))
    for r, out in enumerate(res):  # place_ray_sharded: the rank's band of rows
        torch.testing.assert_close(out["band"], ref.rgb[:, 4 * r:4 * (r + 1)], rtol=0, atol=1e-6)
        for k in ("rgb", "sdf"):
            torch.testing.assert_close(out["rays"][k], getattr(ref, k), rtol=0, atol=1e-6)
            np.testing.assert_allclose(out["rays"][k].numpy(), np.asarray(getattr(jref, k)),
                                       rtol=1e-4, atol=1e-5)
        assert "must divide" in out["rays_divide_error"]
        assert "batch 9 must divide the 2-rank world" in out["divide_error"]
        for i in range(2):
            torch.testing.assert_close(out[f"images{i}"], res[0][f"images{i}"], rtol=0, atol=0)
    one = SDFaceSampler(g, batch=GLOBAL).sample(seed=5)
    torch.testing.assert_close(res[0]["images0"], one, rtol=0, atol=1e-5)
    gfix = generator.Generator(pfix, device="cpu")
    gfix.load_state_dict(sd)
    torch.testing.assert_close(res[0]["images1"], SDFaceSampler(
        gfix, batch=GLOBAL, truncation=1.0).sample(**fixed), rtol=0, atol=1e-5)
    # (untruncated: the two packages' truncation means come from different draws)
    js = JSampler(params, jfix, batch=GLOBAL, truncation=1.0,
                  mesh=j_par.make_mesh(jax.devices()[:2]))
    jimg = np.asarray(js.sample(z=jnp.asarray(z), **SAMPLE_FIXED))
    np.testing.assert_allclose(res[0]["images1"].numpy(), jimg, rtol=1e-4, atol=1e-4)
