"""Stage C (the inversion encoders' training) in the port against the JAX
package, on the CPU.

``encoder_loss`` of each encoder against JAX's loss on the same weights
(the JAX initializers, crossed by ``utils/convert.py``) and the same
inputs (images, thumbs, cameras, the VAE's reparameterisation noise, the
pSp mean styles), with the generator's forward deterministic on both
sides (JAX ``key=None``, the port's ``generator=None``).  The JAX loss is
composed here from the JAX package's functions, as its ``make_encoder_step``
composes it.  Tolerances: loss ``rtol 1e-4``; every encoder gradient
within 1e-3 of the JAX gradient's norm (plus 1e-6 for the ones that are
~0).  Then the loop (a frozen generator, resume after ``exit_after``) and
``python -m sdface_gan_tpu_torch.train --vae 1`` / ``--psp 1``.
"""

import json
import math
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdface_gan_tpu.encoder import losses as j_losses  # noqa: E402
from sdface_gan_tpu.encoder import lpips as j_lpips  # noqa: E402
from sdface_gan_tpu.encoder import psp as j_psp  # noqa: E402
from sdface_gan_tpu.encoder import vae as j_vae  # noqa: E402
from sdface_gan_tpu.geometry import generate_camera_params as j_cams  # noqa: E402
from sdface_gan_tpu.models import generator as j_gen  # noqa: E402
from sdface_gan_tpu.models import renderer as j_rend  # noqa: E402
from sdface_gan_tpu.training import encoder_loop as j_loop  # noqa: E402
from sdface_gan_tpu_torch import encoder  # noqa: E402
from sdface_gan_tpu_torch import train as train_cli  # noqa: E402
from sdface_gan_tpu_torch.geometry import CameraParams  # noqa: E402
from sdface_gan_tpu_torch.models import generator, renderer  # noqa: E402
from sdface_gan_tpu_torch.training import encoder_loop  # noqa: E402
from sdface_gan_tpu_torch.utils import checkpoints  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import (  # noqa: E402
    jax_lpips_params_to_state_dict,
    jax_params_to_state_dict,
    jax_psp_params_to_state_dict,
    jax_vae_params_to_state_dict,
)

LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3, 1e-6
BATCH = 2
PSP_RES = 64


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two threads for torch and BLAS while this module runs: its CPU
    convolutions otherwise oversubscribe a machine that runs the suite in
    several workers at once."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(2):
            yield
    finally:
        torch.set_num_threads(n)


def _jit(fn, **kw):
    """``jax.jit`` with XLA's quick compile: the JAX side runs once per test,
    and eagerly JAX compiles every operation apart (IR-SE-50's init and the
    pSp loss's backward: minutes eagerly)."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0,
                                         "xla_llvm_disable_expensive_passes": True}, **kw)


def _t(x):
    return torch.from_numpy(np.array(x))


def _images(seed, n, res):
    return np.random.default_rng(seed).uniform(-1, 1, (n, res, res, 3)).astype(np.float32)


def _gcfgs(style, size, **kw):
    rkw = dict(type="sdf", out_im_res=8, n_samples=4, style_dim=style, width=16, depth=1)
    gkw = dict(size=size, style_dim=style, full_pipeline=True, freeze_renderer=True,
               channel_multiplier=1, **kw)
    return (j_gen.GeneratorConfig(renderer=j_rend.RendererConfig(**rkw), **gkw),
            generator.GeneratorConfig(renderer=renderer.RendererConfig(**rkw), **gkw))


def _generators(jcfg, pcfg, seed=1):
    gp = j_gen.init_generator(jax.random.PRNGKey(seed), jcfg)
    g = generator.Generator(pcfg, device="cpu")
    g.load_state_dict(jax_params_to_state_dict(gp, pcfg))
    return gp, g


def _jax_value_and_grad(ep, gp, jcfg, ecfg, loss_utils, imgs, thumbs, jc, **kw):
    """``jax.value_and_grad`` of :func:`_jax_loss` with respect to ``ep``,
    jitted over the arrays (the configs, the loss's nets and the cameras
    closed over)."""
    def loss(ep, gp, imgs, thumbs, kw):
        return _jax_loss(ep, gp, jcfg, ecfg, loss_utils, imgs, thumbs, jc, **kw)

    return _jit(jax.value_and_grad(loss))(ep, gp, imgs, thumbs, kw)


def _jax_loss(ep, gp, jcfg, ecfg, loss_utils, imgs, thumbs, jc, eps=None, latent_avg=None):
    """JAX ``make_encoder_step``'s ``loss_fn`` with the forward's key None
    and the reparameterisation noise given."""
    cam_args = (jc.extrinsics, jc.focal, jc.near, jc.far)
    if isinstance(ecfg, j_psp.PSPConfig):
        rend, wplus = j_psp.apply_psp_encoder(ep, ecfg, imgs)
        if latent_avg is not None:
            rend, wplus = rend + latent_avg[0], wplus + latent_avg[1]
        out = j_gen.generator_forward(gp, jcfg, [wplus], *cam_args, key=None,
                                      input_is_latent=True, renderer_latent=rend)
        kl = jnp.zeros(())
    else:
        mu, logvar = j_vae.apply_vae_encoder(ep, ecfg, imgs)
        z = mu + jnp.exp(0.5 * logvar) * eps  # reparameterize with its draw given
        out = j_gen.generator_forward(gp, jcfg, [z], *cam_args, key=None)
        kl = j_vae.kl_divergence(mu, logvar)
    thumb = j_loop.THUMB_LOSS(out.thumb_rgb, thumbs)
    full = loss_utils(out.rgb if out.rgb is not None else out.thumb_rgb, imgs)
    return 0.5 * thumb["loss"] + 0.5 * full["loss"] + 0.005 * kl


def _assert_encoder_grads(e, loss, ref_sd):
    named = list(e.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    for (name, p), g in zip(named, grads):
        r = ref_sd[name]
        g = torch.zeros_like(p) if g is None else g
        err, scale = (g - r).norm().item(), r.norm().item()
        assert err <= GRAD_RTOL * scale + GRAD_ATOL, (name, err, scale)


def test_vae_encoder_loss_matches_jax():
    """The VAE path: z = mu + exp(logvar / 2) eps with JAX's eps, the frozen
    generator's forward, thumb and full L2, KL."""
    jcfg, pcfg = _gcfgs(16, 16)
    gp, g = _generators(jcfg, pcfg)
    jecfg = j_vae.VAEEncoderConfig(img_size=16, z_size=16)
    ep = j_vae.init_vae_encoder(jax.random.PRNGKey(2), jecfg)
    e = encoder.VAEEncoder(encoder.VAEEncoderConfig(img_size=16, z_size=16))
    e.load_state_dict(jax_vae_params_to_state_dict(ep))
    imgs, thumbs = _images(0, BATCH, 16), _images(1, BATCH, 8)
    eps = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (BATCH, 16)))
    jc = j_cams(8, jax.random.PRNGKey(3), batch=BATCH)
    lj, gj = _jax_value_and_grad(ep, gp, jcfg, jecfg, j_losses.LossUtils(),
                                 jnp.asarray(imgs), jnp.asarray(thumbs), jc,
                                 eps=jnp.asarray(eps))
    inputs = encoder_loop.EncoderInputs(_t(imgs), _t(thumbs), CameraParams(*map(_t, jc)),
                                        eps=_t(eps))
    g.requires_grad_(False)
    loss, m = encoder_loop.encoder_loss(e, g, pcfg, e.cfg, encoder.LossUtils(), inputs)
    np.testing.assert_allclose(loss.item(), float(lj), rtol=LOSS_RTOL)
    assert m["e_kl"].item() > 0 and set(m) == {"e_loss", "e_kl", "e_l2_thumb", "e_l2_full"}
    _assert_encoder_grads(e, loss, jax_vae_params_to_state_dict(gj))


def test_psp_encoder_loss_matches_jax():
    """The pSp path at 64^2: the W+ stack and the renderer projection as
    offsets from injected mean styles (``start_from_avg``), the frozen
    generator, thumb L2, and full-res L2 with the LPIPS term on.  (The ID
    term needs 256^2 images; ``LossUtils`` with it, and the gradient through
    it, is held in ``test_torch_port_encoder.py``, and the whole pSp E step
    at 256^2 with both terms on the card against the CPU by
    ``chip_smoke.py``.)"""
    jcfg, pcfg = _gcfgs(256, PSP_RES, channel_base=32)
    gp, g = _generators(jcfg, pcfg)
    n_latent = jcfg.decoder.n_latent
    jecfg = j_psp.PSPConfig(img_size=PSP_RES, style_count=n_latent, renderer_style_dim=256)
    ep = _jit(j_psp.init_psp_encoder, static_argnums=1)(jax.random.PRNGKey(2), jecfg)
    e = encoder.PSPEncoder(encoder.PSPConfig(img_size=PSP_RES, style_count=n_latent,
                                             renderer_style_dim=256))
    e.load_state_dict(jax_psp_params_to_state_dict(ep))
    lp = _jit(j_lpips.init_lpips)(jax.random.PRNGKey(5))
    lnet = encoder.LPIPS()
    lnet.load_state_dict(jax_lpips_params_to_state_dict(lp))
    rng = np.random.default_rng(6)
    avg = (0.1 * rng.standard_normal((1, 256)).astype(np.float32),
           0.1 * rng.standard_normal((1, 512)).astype(np.float32))
    imgs, thumbs = _images(7, BATCH, PSP_RES), _images(8, BATCH, 8)
    jc = j_cams(8, jax.random.PRNGKey(3), batch=BATCH)
    lj, gj = _jax_value_and_grad(
        ep, gp, jcfg, jecfg, j_losses.LossUtils(lpips_params=lp),
        jnp.asarray(imgs), jnp.asarray(thumbs), jc,
        latent_avg=tuple(map(jnp.asarray, avg)))
    inputs = encoder_loop.EncoderInputs(_t(imgs), _t(thumbs), CameraParams(*map(_t, jc)))
    g.requires_grad_(False)
    loss, m = encoder_loop.encoder_loss(e, g, pcfg, e.cfg,
                                        encoder.LossUtils(lpips=lnet), inputs,
                                        latent_avg=tuple(map(_t, avg)))
    np.testing.assert_allclose(loss.item(), float(lj), rtol=LOSS_RTOL)
    assert "e_lpips" in m
    _assert_encoder_grads(e, loss, jax_psp_params_to_state_dict(gj))


TINY_G = dict(style=16, size=16)


def _tiny_port_g(seed=1):
    _, pcfg = _gcfgs(**TINY_G)
    return pcfg, generator.Generator(pcfg, device="cpu",
                                     generator=torch.Generator().manual_seed(seed))


def _constant_loader(img_res, thumb_res, seed=0):
    """The same batch every time: a resumed run then sees what the straight
    run saw at each step (the draws come from (seed, step) anyway)."""
    imgs, thumbs = _images(seed, BATCH, img_res), _images(seed + 1, BATCH, thumb_res)
    while True:
        yield imgs, thumbs


def test_the_frozen_generator_takes_no_gradient():
    """An E step moves the encoder alone: the generator's parameters take no
    gradient and stay bit-equal, and its frozen renderer runs without
    autograd (so on an NGP generator only the encode's forward runs)."""
    pcfg, g = _tiny_port_g()
    before = {k: v.clone() for k, v in g.state_dict().items()}
    e = encoder.VAEEncoder(encoder.VAEEncoderConfig(img_size=16, z_size=16))
    e_before = {k: v.clone() for k, v in e.state_dict().items()}
    g.requires_grad_(False)
    opt = encoder_loop.encoder_optimizer(e.parameters(), vae=True)
    gen = torch.Generator().manual_seed(0)
    inputs = encoder_loop.sample_encoder_inputs(_t(_images(0, BATCH, 16)),
                                                _t(_images(1, BATCH, 8)), 8, gen)
    m = encoder_loop.encoder_step(e, g, opt, pcfg, e.cfg, encoder.LossUtils(), inputs)
    assert all(math.isfinite(v.item()) for v in m.values())
    assert all(p.grad is None and not p.requires_grad for p in g.parameters())
    for k, v in g.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert any(not torch.equal(v, e_before[k]) for k, v in e.state_dict().items())
    with torch.enable_grad():
        z = torch.randn(BATCH, 16, requires_grad=True)
        out = generator.generator_forward(g, pcfg, [z], *inputs.cams[:4])
    assert not out.thumb_rgb.requires_grad and out.rgb.requires_grad


def _fast_clock(monkeypatch):
    """The loop's clock reads 0 at the start and one more per iteration, so
    ``exit_after = n - 0.5`` cuts after iteration n - 1."""
    ticks = iter(range(10 ** 9))
    monkeypatch.setattr(encoder_loop, "time", types.SimpleNamespace(
        time=lambda: float(next(ticks))))


@pytest.mark.parametrize("kind,k", [("vae", 4), ("psp", 8)])
def test_train_encoder_resumes_where_it_was_cut(tmp_path, monkeypatch, kind, k):
    """k steps straight equal k/2 steps, the ``exit_after`` cut (exit code 3
    and a ``models_*`` checkpoint with the optimizer state), and a resumed
    run of the rest: the encoder to 1e-6.  pSp runs Ranger over a lookahead
    sync (step 6) after the cut."""
    if kind == "psp":
        _, pcfg = _gcfgs(256, 16)
        g_seed = generator.Generator(pcfg, device="cpu")
        ecfg = encoder.PSPConfig(img_size=16, style_count=pcfg.decoder.n_latent,
                                 renderer_style_dim=256)
    else:
        pcfg, g_seed = _tiny_port_g()
        ecfg = encoder.VAEEncoderConfig(img_size=16, z_size=16)
    state = g_seed.state_dict()

    def run(out, iters, **kw):
        g = generator.Generator(pcfg, device="cpu")
        g.load_state_dict(state)
        return encoder_loop.train_encoder(_constant_loader(16, 8), pcfg, g, ecfg, str(out),
                                          iters=iters, log_every=1, save_every=0,
                                          sample_every=0, device="cpu", **kw)

    straight = run(tmp_path / "straight", k)
    cut = tmp_path / "cut"
    with monkeypatch.context() as mp:
        _fast_clock(mp)
        with pytest.raises(SystemExit) as exc:
            run(cut, k, exit_after=k // 2 - 0.5)
    assert exc.value.code == 3
    assert checkpoints.latest_checkpoint_step(str(cut)) == k // 2 - 1
    assert not checkpoints.checkpoint_exists(str(cut), "encoder")
    resumed = run(cut, k)
    for (name, a), b in zip(straight.state_dict().items(), resumed.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-6, msg=name)
    final = checkpoints.load_checkpoint(str(cut), "encoder")
    assert set(final) == {"e", "g_ema"}
    with open(cut / "encoder_metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == list(range(k))
    if kind == "psp":
        ck = checkpoints.load_checkpoint(str(cut), f"models_{k // 2 - 1:07d}")
        assert all(s["step"] == k // 2 and "slow" in s for s in ck["e_opt"]["state"].values())


def test_train_encoder_writes_the_eval_strip_and_sweeps(tmp_path):
    pcfg, g = _tiny_port_g()
    out = tmp_path / "enc"
    encoder_loop.train_encoder(_constant_loader(16, 8), pcfg, g,
                               encoder.VAEEncoderConfig(img_size=16, z_size=16), str(out),
                               iters=3, log_every=1, save_every=2, sample_every=2,
                               val_n_sample=2, device="cpu")
    for name in ("eval.png", "samples_0000000.png", "samples_0000002.png",
                 "models_0000002.pt", "encoder.pt"):
        assert (out / name).exists(), name


def test_psp_equal_resolution_decoder(tmp_path):
    """A decoder whose input resolution equals its output (renderer
    out_im_res == size, as in the 64^2 synthetic config) has n_latent == 2,
    below the FPN's default split points: the W+ stack clamps them."""
    rkw = dict(type="sdf", out_im_res=16, n_samples=4, style_dim=256, width=16, depth=1)
    pcfg = generator.GeneratorConfig(size=16, style_dim=256, full_pipeline=True,
                                     freeze_renderer=True, channel_multiplier=1,
                                     renderer=renderer.RendererConfig(**rkw))
    assert pcfg.decoder.n_latent == 2
    g = generator.Generator(pcfg, device="cpu")
    ecfg = encoder.PSPConfig(img_size=16, style_count=pcfg.decoder.n_latent,
                             renderer_style_dim=pcfg.style_dim)
    e = encoder_loop.train_encoder(_constant_loader(16, 16), pcfg, g, ecfg,
                                   str(tmp_path / "psp_eq"), iters=2, log_every=1,
                                   save_every=0, sample_every=0, val_n_sample=1, device="cpu")
    assert all(torch.isfinite(v).all() for v in e.state_dict().values())


def test_psp_rejects_non512_decoder(tmp_path):
    pcfg, g = _tiny_port_g()  # style_dim 16: decoder style 32
    ecfg = encoder.PSPConfig(img_size=16, style_count=pcfg.decoder.n_latent,
                             renderer_style_dim=pcfg.style_dim)
    with pytest.raises(ValueError, match="512"):
        encoder_loop.train_encoder(_constant_loader(16, 8), pcfg, g, ecfg,
                                   str(tmp_path / "x"), iters=1, device="cpu")


# --- the train CLI --------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# style_dim 256 (the decoder's 512-d styles pSp needs), everything else tiny
TINY_C = """inherit_from: configs/256res/ffhq_256_sdf.yaml
training:
  out_dir: out/{exp}
data:
  img_size: 16
rendering:
  width: 16
  depth: 1
  N_samples: 4
train_args:
  renderer_spatial_output_dim: 8
  size: 16
  style_dim: 256
  channel_multiplier: 1
"""


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    from sdface_gan_tpu_torch import prepare_data as prepare_cli
    from sdface_gan_tpu_torch.data.png import encode_png

    root = tmp_path_factory.mktemp("stage_c_cli")
    os.symlink(os.path.join(REPO, "configs"), root / "configs")
    (root / "imgs").mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        (root / "imgs" / f"{i:03d}.png").write_bytes(
            encode_png(rng.integers(0, 256, (20, 18, 3), dtype=np.uint8)))
    (root / "tiny_c.yaml").write_text(TINY_C.format(exp="tiny_c"))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        prepare_cli.main(["imgs", "--out", "store", "--size", "16", "--n_worker", "1"])
    return root


def _cli_args(*more):
    return ["--config", "tiny_c.yaml", "--sdf", "1", "--dataset_path", "store", "--batch", "2",
            "--sphere_init_iters", "1", "--iters", "2", "--log_every", "1", "--save_every",
            "1000", "--sample_every", "1000", "--device", "cpu", *more]


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("kind", ["vae", "psp"])
def test_train_cli_runs_stage_c_after_a_and_b(ws, monkeypatch, capsys, kind):
    """``train --vae 1`` / ``--psp 1``: stages A and B first (trained by the
    first command, skipped by the second), then stage C into ``encoder`` /
    ``encoder_psp``; every logged loss finite, ``e_ms`` logged."""
    monkeypatch.chdir(ws)
    train_cli.main(_cli_args(f"--{kind}", "1"))
    out = ws / "out" / "tiny_c"
    assert checkpoints.checkpoint_exists(str(out), "full_pipeline")
    enc = out / ("encoder_psp" if kind == "psp" else "encoder")
    assert checkpoints.checkpoint_exists(str(enc), "encoder")
    rows = _rows(enc / "encoder_metrics.jsonl")
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        assert "e_ms" in r and all(math.isfinite(v) for v in r.values()), r
    final = checkpoints.load_checkpoint(str(enc), "encoder")
    ref = checkpoints.load_checkpoint(str(out), "full_pipeline")["g_ema"]
    for k, v in final["g_ema"].items():
        assert torch.equal(v, ref[k]), k
