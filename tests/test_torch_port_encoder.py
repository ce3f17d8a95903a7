"""Stage C's modules in the port against the JAX package, on the CPU.

Weights come from the JAX initializers (``init_*``) and cross by the
converters (``jax_{vae,psp,irse,lpips}_params_to_state_dict``); inputs are
made once with numpy and given to both sides (f32, JAX at "highest" matmul
precision).  Tolerances: module outputs within 1e-4 of their max |value|;
losses ``rtol 1e-4``; a gradient holds when the norm of its difference is
at most 1e-3 of the JAX gradient's norm; Ranger's parameters within
``rtol 1e-5`` over 13 steps (RAdam's switch to the rectified update at
step 6 and the lookahead syncs at steps 6 and 12 among them).
"""

import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from sdface_gan_tpu.encoder import id_loss as j_id_loss  # noqa: E402  (the function)
from sdface_gan_tpu.encoder import irse as j_irse  # noqa: E402
from sdface_gan_tpu.encoder import losses as j_losses  # noqa: E402
from sdface_gan_tpu.encoder import lpips as j_lpips  # noqa: E402
from sdface_gan_tpu.encoder import psp as j_psp  # noqa: E402
from sdface_gan_tpu.encoder import vae as j_vae  # noqa: E402
from sdface_gan_tpu.training import optim as j_optim  # noqa: E402
from sdface_gan_tpu_torch import encoder  # noqa: E402
from sdface_gan_tpu_torch.encoder import irse, lpips, psp, vae  # noqa: E402
from sdface_gan_tpu_torch.training import encoder_loop, optim  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import (  # noqa: E402
    jax_irse_params_to_state_dict,
    jax_lpips_params_to_state_dict,
    jax_psp_params_to_state_dict,
    jax_vae_params_to_state_dict,
)

OUT_TOL = 1e-4  # of max |output|
LOSS_RTOL, GRAD_RTOL = 1e-4, 1e-3
RANGER_RTOL = 1e-5


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


def _t(x):
    return torch.from_numpy(np.array(x))


def _images(seed, n, res):
    return np.random.default_rng(seed).uniform(-1, 1, (n, res, res, 3)).astype(np.float32)


def _close_to_max(got, want, tol=OUT_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


def _grad_close(got, want, rtol=GRAD_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.linalg.norm(got - want) <= rtol * np.linalg.norm(want), (
        np.linalg.norm(got - want), np.linalg.norm(want))


def _perturbed_bn(tree, seed):
    """BN leaves moved off identity (scale, bias, mean, var), so the tests see
    the statistics used; other leaves as they are."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            if {"scale", "bias", "mean", "var"} <= set(node):
                n = np.asarray(node["scale"]).shape
                return {"scale": jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32),
                        "bias": jnp.asarray(rng.normal(0, 0.1, n), jnp.float32),
                        "mean": jnp.asarray(rng.normal(0, 0.1, n), jnp.float32),
                        "var": jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(tree)


@pytest.fixture(scope="module")
def irse_net():
    params = _perturbed_bn(j_irse.init_irse_backbone(jax.random.PRNGKey(3)), 3)
    net = irse.IRSEBackbone()
    net.load_state_dict(jax_irse_params_to_state_dict(params))
    return params, net.requires_grad_(False)


@pytest.fixture(scope="module")
def lpips_net():
    params = j_lpips.init_lpips(jax.random.PRNGKey(4))
    # LPIPS lins are non-negative in the pretrained net; random ones straddle 0
    net = lpips.LPIPS()
    net.load_state_dict(jax_lpips_params_to_state_dict(params))
    return params, net.requires_grad_(False)


def test_vae_encoder_matches_jax():
    cfg = j_vae.VAEEncoderConfig(img_size=16, z_size=16)
    params = j_vae.init_vae_encoder(jax.random.PRNGKey(1), cfg)
    net = vae.VAEEncoder(vae.VAEEncoderConfig(img_size=16, z_size=16))
    net.load_state_dict(jax_vae_params_to_state_dict(params))
    x = _images(0, 3, 16)
    mu_j, lv_j = j_vae.apply_vae_encoder(params, cfg, jnp.asarray(x))
    mu, lv = net(_t(x))
    _close_to_max(mu.detach(), mu_j)
    _close_to_max(lv.detach(), lv_j)
    # batch statistics, also in eval mode (the reconstruction pass)
    mu_eval, _ = net.eval()(_t(x))
    torch.testing.assert_close(mu_eval, mu, rtol=0, atol=0)
    eps = np.random.default_rng(1).normal(size=mu_j.shape).astype(np.float32)
    z_j = mu_j + jnp.exp(0.5 * lv_j) * eps
    _close_to_max(vae.reparameterize(mu, lv, eps=_t(eps)).detach(), z_j)
    np.testing.assert_allclose(vae.kl_divergence(mu, lv).item(),
                               float(j_vae.kl_divergence(mu_j, lv_j)), rtol=LOSS_RTOL)


def test_vae_batch_norm_uses_the_biased_variance():
    bn = encoder._layers.BatchStatNorm(4)
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    want = (x - x.mean(0)) / torch.sqrt(x.var(0, unbiased=False) + 1e-5)
    torch.testing.assert_close(bn(x), want, rtol=1e-6, atol=1e-6)


def test_irse_embedding_matches_jax(irse_net):
    params, net = irse_net
    x = _images(2, 2, 112)
    want = j_irse.apply_irse_backbone(params, jnp.asarray(x))
    _close_to_max(net(_t(x)), want)


def test_gradual_style_encoder_matches_jax():
    cfg = j_psp.PSPConfig(img_size=64, style_count=6, renderer_style_dim=16)
    params = j_psp.init_psp_encoder(jax.random.PRNGKey(5), cfg)
    params["gse"]["backbone"] = _perturbed_bn(params["gse"]["backbone"], 5)
    net = psp.PSPEncoder(psp.PSPConfig(img_size=64, style_count=6, renderer_style_dim=16))
    net.load_state_dict(jax_psp_params_to_state_dict(params))
    x = _images(3, 2, 64)
    rend_j, wplus_j = j_psp.apply_psp_encoder(params, cfg, jnp.asarray(x))
    rend, wplus = net(_t(x))
    _close_to_max(wplus.detach(), wplus_j)
    _close_to_max(rend.detach(), rend_j)


@pytest.mark.parametrize("style_count", [2, 6, 18])
def test_psp_fpn_split_points_clamp_as_jax(style_count):
    ours = psp.PSPConfig(style_count=style_count).irse
    ref = j_psp.PSPConfig(style_count=style_count).irse
    assert (ours.coarse_ind, ours.middle_ind, ours.style_count) == (
        ref.coarse_ind, ref.middle_ind, ref.style_count)


def test_upsample_is_half_pixel_bilinear():
    """The FPN's upsampling against jax.image.resize(bilinear)."""
    x = np.random.default_rng(4).normal(size=(1, 4, 4, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, 8, 8, 3), method="bilinear")
    got = irse._upsample_to(_t(x).permute(0, 3, 1, 2), torch.zeros(1, 1, 8, 8))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)


def _loss_and_grad_jax(fn, gen):
    return jax.value_and_grad(fn)(jnp.asarray(gen))


def _loss_and_grad_torch(fn, gen):
    g = _t(gen).requires_grad_(True)
    loss = fn(g)
    (grad,) = torch.autograd.grad(loss, [g])
    return loss.item(), grad.numpy()


def test_id_loss_matches_jax(irse_net):
    """The crop, the antialiased 188 -> 112 shrink, the embedding, the
    detached real side: loss and the gradient through them."""
    params, net = irse_net
    gen, real = _images(5, 2, 256), _images(6, 2, 256)
    lj, gj = _loss_and_grad_jax(lambda g: j_id_loss(params, g, jnp.asarray(real)), gen)
    lt, gt = _loss_and_grad_torch(lambda g: encoder.id_loss(net, g, _t(real)), gen)
    np.testing.assert_allclose(lt, float(lj), rtol=LOSS_RTOL)
    _grad_close(gt, gj)
    # the shrink antialiases: without it the features move well past the bar
    crop = _t(gen)[:, 35:223, 32:220].permute(0, 3, 1, 2)
    plain = torch.nn.functional.interpolate(crop, size=(112, 112), mode="bilinear",
                                            align_corners=False)
    want = jax.image.resize(jnp.asarray(gen)[:, 35:223, 32:220], (2, 112, 112, 3), "bilinear")
    assert np.max(np.abs(plain.permute(0, 2, 3, 1).numpy() - np.asarray(want))) > 1e-2


def test_lpips_matches_jax(lpips_net):
    params, net = lpips_net
    gen, real = _images(7, 2, 64), _images(8, 2, 64)
    lj, gj = _loss_and_grad_jax(lambda g: j_lpips.apply_lpips(params, g, jnp.asarray(real)),
                                gen)
    lt, gt = _loss_and_grad_torch(lambda g: net(g, _t(real)), gen)
    np.testing.assert_allclose(lt, float(lj), rtol=LOSS_RTOL)
    _grad_close(gt, gj)


def test_loss_utils_matches_jax(irse_net, lpips_net):
    (ip, inet), (lp, lnet) = irse_net, lpips_net
    gen, real = _images(9, 2, 256), _images(10, 2, 256)
    jl = j_losses.LossUtils(irse_params=ip, lpips_params=lp)
    tl = encoder.LossUtils(irse=inet, lpips=lnet)
    out_j = jl(jnp.asarray(gen), jnp.asarray(real))
    out_t = tl(_t(gen), _t(real))
    assert set(out_t) == set(out_j) == {"l2", "id", "lpips", "loss"}
    for k in out_j:
        np.testing.assert_allclose(out_t[k].item(), float(out_j[k]), rtol=LOSS_RTOL)
    lj, gj = _loss_and_grad_jax(lambda g: jl(g, jnp.asarray(real))["loss"], gen)
    lt, gt = _loss_and_grad_torch(lambda g: tl(g, _t(real))["loss"], gen)
    _grad_close(gt, gj)
    # a term is off when its net is None; the nets take no gradient
    assert set(encoder.LossUtils()(_t(gen), _t(real))) == {"l2", "loss"}
    assert not any(p.requires_grad for p in inet.parameters())


def _fake_irse_archive(seed=0):
    """A torch-layout ``model_ir_se50.pth`` state dict (the key set of
    ``import_irse_state``): weights N(0, 1/fan_in), BN scales and variances
    in [0.5, 1.5), so that distinct faces keep distinct embeddings."""
    g = torch.Generator().manual_seed(seed)
    ref = irse.IRSEBackbone().state_dict()
    bn_of = {k.rsplit(".", 1)[0] for k in ref if k.endswith("running_var")}
    out = {}
    for k, v in ref.items():
        module, leaf = k.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            out[k] = torch.tensor(7)
        elif module in bn_of and leaf in ("weight", "running_var"):
            out[k] = torch.rand(v.shape, generator=g) + 0.5
        elif module in bn_of or leaf == "bias":
            out[k] = 0.1 * torch.randn(v.shape, generator=g)
        elif v.ndim == 1:  # PReLU slopes
            out[k] = 0.25 + 0.05 * torch.randn(v.shape, generator=g)
        else:
            out[k] = torch.randn(v.shape, generator=g) / float(np.sqrt(v[0].numel()))
    return out


def _fake_lpips_archive(seed=0):
    g = torch.Generator().manual_seed(seed)
    alex = {}
    chans = [(3, 64, 11), (64, 192, 5), (192, 384, 3), (384, 256, 3), (256, 256, 3)]
    for cid, (ic, oc, k) in zip(lpips.ALEX_CONV_IDS, chans):
        alex[f"features.{cid}.weight"] = 0.02 * torch.randn(oc, ic, k, k, generator=g)
        alex[f"features.{cid}.bias"] = 0.01 * torch.randn(oc, generator=g)
    alex["classifier.1.weight"] = torch.zeros(4, 4)  # a full AlexNet's head, ignored
    lin = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=g)
           for i, c in enumerate([64, 192, 384, 256, 256])}
    return {"alex": alex, "lin": lin}


def test_perceptual_archives_load_as_the_jax_importers(tmp_path):
    """One synthesized torch archive of each net, read by the JAX importers
    and by the port's ``load_state_dict``: the same weights (1e-6), the same
    outputs, and ``load_perceptual_params`` turns both terms on."""
    irse_state, lpips_bundle = _fake_irse_archive(), _fake_lpips_archive()
    jp = j_irse.import_irse_state({k: v.numpy() for k, v in irse_state.items()},
                                  j_irse.init_irse_backbone(jax.random.PRNGKey(0)))
    ours = irse.IRSEBackbone()
    ours.load_state_dict(irse_state)
    for k, v in jax_irse_params_to_state_dict(jp).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(ours.state_dict()[k].numpy(), v.numpy(), atol=1e-6)
    x = _images(11, 1, 112)
    _close_to_max(ours(_t(x)).detach(), j_irse.apply_irse_backbone(jp, jnp.asarray(x)))

    jl = j_lpips.import_lpips_state({k: v.numpy() for k, v in lpips_bundle["alex"].items()},
                                    {k: v.numpy() for k, v in lpips_bundle["lin"].items()},
                                    j_lpips.init_lpips(jax.random.PRNGKey(0)))
    lnet = lpips.load_lpips_archive(lpips.LPIPS(), lpips_bundle)
    for k, v in jax_lpips_params_to_state_dict(jl).items():
        np.testing.assert_allclose(lnet.state_dict()[k].numpy(), v.numpy(), atol=1e-6)

    irse_path, lpips_path = tmp_path / "model_ir_se50.pth", tmp_path / "lpips.pth"
    torch.save(irse_state, irse_path)
    torch.save(lpips_bundle, lpips_path)
    lu = encoder_loop.load_perceptual_params(
        argparse.Namespace(irse_weights=str(irse_path), lpips_weights=str(lpips_path)),
        device="cpu")
    gen, real = _images(12, 1, 256), _images(13, 1, 256)
    out = lu(_t(gen), _t(real))
    ref = j_losses.LossUtils(irse_params=jp, lpips_params=jl)(jnp.asarray(gen), jnp.asarray(real))
    assert float(ref["id"]) > 1e-3  # distinct faces, distinct embeddings
    for k in ("l2", "id", "lpips", "loss"):
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=LOSS_RTOL)


def test_irse_archive_without_its_head(tmp_path):
    """An archive without ``output_layer.*`` warm-starts the pSp backbone (the
    JAX importer allows it; the FPN never runs the head) and is refused for
    the ID loss, whose embedding the head makes."""
    state = {k: v for k, v in _fake_irse_archive().items()
             if not k.startswith("output_layer.")}
    path = tmp_path / "no_head.pth"
    torch.save(state, path)
    e = psp.PSPEncoder(psp.PSPConfig(img_size=16, style_count=2, renderer_style_dim=16))
    head = {k: v.clone() for k, v in e.gse.backbone.output_layer.state_dict().items()}
    encoder_loop.load_irse_archive(e.gse.backbone, str(path), head=False)
    torch.testing.assert_close(e.gse.backbone.input_layer[0].weight,
                               state["input_layer.0.weight"], rtol=0, atol=0)
    for k, v in e.gse.backbone.output_layer.state_dict().items():
        torch.testing.assert_close(v, head[k], rtol=0, atol=0)
    with pytest.raises(KeyError, match="output_layer"):
        encoder_loop.load_irse_archive(irse.IRSEBackbone(), str(path))


# --- Ranger -----------------------------------------------------------------

RANGER_SHAPES = {"conv": (3, 3, 4, 5), "conv1x1": (1, 1, 6, 2), "linear": (7, 3), "bias": (5,)}


def _to_port_layout(name, a):
    """JAX HWIO / [in, out] -> the port's OIHW / [out, in]."""
    a = np.asarray(a)
    if a.ndim == 4:
        return np.transpose(a, (3, 2, 0, 1))
    if a.ndim == 2:
        return a.T
    return a


def _ranger_problem(steps=13):
    """Parameters at the scale of trained weights (~1e-3, so f32 rounding of
    the parameters stays far below the 13 steps' movement) and N(0, 1)
    gradients."""
    rng = np.random.default_rng(0)
    p0 = {k: (1e-3 * rng.normal(size=s)).astype(np.float32) for k, s in RANGER_SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in RANGER_SHAPES.items()}
             for _ in range(steps)]
    return p0, grads


def _ranger_runs():
    p0, grads = _ranger_problem()
    tx = j_optim.ranger(1e-4)
    # jitted, as the JAX loop runs it (eagerly, b^t takes another pow)
    update = jax.jit(tx.update)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    jax_traj = []
    for g in grads:
        u, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, u)
        jax_traj.append({k: np.asarray(v) for k, v in jp.items()})
    params = {k: torch.nn.Parameter(_t(_to_port_layout(k, v))) for k, v in p0.items()}
    opt = optim.Ranger(list(params.values()), 1e-4)
    port_traj = []
    for g in grads:
        for k, p in params.items():
            p.grad = _t(_to_port_layout(k, g[k]))
        opt.step()
        port_traj.append({k: p.detach().numpy().copy() for k, p in params.items()})
    return p0, jax_traj, port_traj, opt


def test_ranger_matches_optax_over_13_steps():
    p0, jax_traj, port_traj, opt = _ranger_runs()
    for i, (jt, pt) in enumerate(zip(jax_traj, port_traj)):
        for k in RANGER_SHAPES:
            want = _to_port_layout(k, jt[k])
            moved = want - _to_port_layout(k, p0[k])
            err = np.max(np.abs(pt[k] - want))
            assert err <= RANGER_RTOL * np.max(np.abs(moved)), (i + 1, k, err)
    # the step counter and the slow weights live in the optimizer state
    state = opt.state_dict()["state"]
    assert all(int(s["step"]) == 13 for s in state.values())


def test_ranger_state_survives_a_checkpoint(tmp_path):
    """Stop after 5 steps, save, load into a new optimizer, run 8 more: the
    same parameters as 13 straight (the lookahead syncs at 6 and 12)."""
    _, _, straight, _ = _ranger_runs()
    p0, grads = _ranger_problem()
    params = {k: torch.nn.Parameter(_t(_to_port_layout(k, v))) for k, v in p0.items()}
    opt = optim.Ranger(list(params.values()), 1e-4)
    for i, g in enumerate(grads):
        if i == 5:
            torch.save({"p": {k: p.detach() for k, p in params.items()},
                        "opt": opt.state_dict()}, tmp_path / "ck.pt")
            ck = torch.load(tmp_path / "ck.pt", weights_only=True)
            params = {k: torch.nn.Parameter(ck["p"][k].clone()) for k in params}
            opt = optim.Ranger(list(params.values()), 1e-4)
            opt.load_state_dict(ck["opt"])
        for k, p in params.items():
            p.grad = _t(_to_port_layout(k, g[k]))
        opt.step()
    for k, p in params.items():
        np.testing.assert_array_equal(p.detach().numpy(), straight[-1][k])


def test_ranger_centralises_over_jax_axes_not_upstreams():
    """JAX centres a gradient over axes 1..ndim of its own layout: for an
    HWIO conv the mean over (kw, in, out) per kh, for a linear [in, out]
    the mean over out per input row.  Upstream Ranger centres each output
    channel.  The port follows JAX; the upstream axes would fail here."""
    rng = np.random.default_rng(3)
    for shape in ((3, 3, 4, 5), (7, 3)):
        g = rng.normal(size=shape).astype(np.float32)
        want = _to_port_layout("", g - g.mean(axis=tuple(range(1, g.ndim)), keepdims=True))
        gp = _t(_to_port_layout("", g))
        got = optim.gradient_centralization(gp).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        upstream = (gp - gp.mean(dim=tuple(range(1, gp.ndim)), keepdim=True)).numpy()
        assert np.max(np.abs(upstream - want)) > 1e-2
    bias = _t(rng.normal(size=(5,)).astype(np.float32))
    torch.testing.assert_close(optim.gradient_centralization(bias), bias, rtol=0, atol=0)


def test_encoder_optimizer_choice():
    net = torch.nn.Linear(2, 2)
    adam = optim.encoder_optimizer(net.parameters(), vae=True)
    assert isinstance(adam, torch.optim.Adam) and adam.defaults["lr"] == 5e-4
    assert adam.defaults["eps"] == 1e-8 and adam.defaults["betas"] == (0.9, 0.999)
    ranger = optim.encoder_optimizer(net.parameters(), vae=False)
    assert isinstance(ranger, optim.Ranger) and ranger.defaults["lr"] == 1e-4
