"""The checkpoint bridge on the CPU: orbax checkpoints of the JAX package,
exported by ``scripts/export_jax_checkpoint.py`` and imported by the port.

* the archive round trip is bit-equal;
* each checkpoint kind imports to exactly the converters' state dicts, its
  optimizer states keyed by the port optimizer's order;
* resume equivalence: a state saved by JAX's ``save_checkpoint`` at step
  k, restored by each package as its own loop restores it, takes the next
  steps on both sides on the same injected inputs (the losses composed
  from the JAX package's functions, as ``test_torch_port_training.py``
  and ``test_torch_port_stage_c.py`` compose them): losses ``rtol 1e-4``,
  every parameter after the steps within 1e-5 of its tensor's largest
  value.  The saved optimizer states come from optax updates on random
  gradients (zero for the decoder's noise inputs, as training leaves them);
* a flagship-width stage-B ``models_*`` crosses bit for bit;
* the committed fixture (``tests/fixtures/jax_run/``, a run trained by the
  JAX package) is JAX's, and the port serves, trains and scores from it;
* refusals: a family not ported, an existing port checkpoint, a noise
  moment that is not zero.
"""

import os
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from sdface_gan_tpu.config import load_config as j_load_config  # noqa: E402
from sdface_gan_tpu.config.yaml_config import default_config_path  # noqa: E402
from sdface_gan_tpu.encoder import losses as j_losses  # noqa: E402
from sdface_gan_tpu.encoder import psp as j_psp  # noqa: E402
from sdface_gan_tpu.encoder import vae as j_vae  # noqa: E402
from sdface_gan_tpu.geometry import generate_camera_params as j_cams  # noqa: E402
from sdface_gan_tpu.losses import gan_losses as j_gan  # noqa: E402
from sdface_gan_tpu.models import discriminator as j_disc  # noqa: E402
from sdface_gan_tpu.models import generator as j_gen  # noqa: E402
from sdface_gan_tpu.models import renderer as j_rend  # noqa: E402
from sdface_gan_tpu.models import stylegan2 as j_sg  # noqa: E402
from sdface_gan_tpu.training import ema as j_ema  # noqa: E402
from sdface_gan_tpu.training import optim as j_optim  # noqa: E402
from sdface_gan_tpu.training import steps as j_steps  # noqa: E402
from sdface_gan_tpu.utils import checkpoints as j_ckpt  # noqa: E402
from sdface_gan_tpu_torch import encoder  # noqa: E402
from sdface_gan_tpu_torch import import_jax_checkpoints as import_cli  # noqa: E402
from sdface_gan_tpu_torch.config import load_config  # noqa: E402
from sdface_gan_tpu_torch.config.yaml_config import default_config_path as port_default  # noqa: E402
from sdface_gan_tpu_torch.geometry import CameraParams  # noqa: E402
from sdface_gan_tpu_torch.models import discriminator  # noqa: E402
from sdface_gan_tpu_torch.models.generator import Generator  # noqa: E402
from sdface_gan_tpu_torch.serving import SDFaceSampler  # noqa: E402
from sdface_gan_tpu_torch.train import stage_configs  # noqa: E402
from sdface_gan_tpu_torch.training import ema, encoder_loop, optim, steps  # noqa: E402
from sdface_gan_tpu_torch.training.encoder_loop import encoder_config  # noqa: E402
from sdface_gan_tpu_torch.utils import checkpoints  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import (  # noqa: E402
    jax_disc_params_to_state_dict,
    jax_params_to_state_dict,
    jax_psp_params_to_state_dict,
    jax_vae_params_to_state_dict,
)
from sdface_gan_tpu_torch.utils.jax_export import read_export  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
from export_jax_checkpoint import export_run  # noqa: E402

from test_torch_port_models import IMAGE_TOL  # noqa: E402
from test_torch_port_stage_c import _gcfgs, _generators, _images, _jax_loss  # noqa: E402
from test_torch_port_training import (  # noqa: E402
    BATCH,
    RES,
    STYLE,
    _cams,
    _configs_a,
    _configs_b,
    _jax_stage_a_g_loss,
    _t,
    _z,
)

FIXTURE = REPO / "tests" / "fixtures" / "jax_run"
LOSS_RTOL, PARAM_RTOL, STEP_RTOL = 1e-4, 1e-5, 2e-3


def _jit(fn, **kw):
    """``jax.jit`` with XLA's quick compile (no backend optimization passes):
    these functions run a few times each, and eagerly JAX compiles every
    operation of every shape apart (IR-SE-50's backward: 28 s eagerly, 5 s
    so)."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0,
                                         "xla_llvm_disable_expensive_passes": True}, **kw)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two threads for torch and BLAS while this module runs, as the other
    port test modules hold themselves."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(2):
            yield
    finally:
        torch.set_num_threads(n)


def _stepper(tx):
    """``tx``'s update and its application, jitted."""
    def step(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state
    return _jit(step)


def _random_updates(tx, params, state, n, seed, frozen=lambda path: False):
    """``n`` optax updates on random gradients (zero where ``frozen(path)``)."""
    rng = np.random.default_rng(seed)
    step = _stepper(tx)
    for _ in range(n):
        grads = jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.zeros_like(x) if frozen(jax.tree_util.keystr(p)) else jnp.asarray(
                rng.standard_normal(x.shape), x.dtype), params)
        params, state = step(grads, state, params)
    return params, state


def _host(tree):
    """``tree``'s arrays as fresh host copies, so that jitted functions see
    one kind of array (restored or jitted ones would compile them anew)."""
    return jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)), tree)


def _is_noise(path: str) -> bool:
    return "'noises'" in path


def _trained(params, seed, scale=0.05):
    """``params`` moved off their init, as a saved run's weights are: each
    tensor by ``scale`` times its spread (``scale`` itself for a constant
    one: biases, noise weights) times N(0, 1).  The decoder's stored noise
    is left as drawn."""
    rng = np.random.default_rng(seed)

    def move(p, x):
        if _is_noise(jax.tree_util.keystr(p)):
            return x
        spread = float(jnp.std(x)) or 1.0
        return x + jnp.asarray(scale * spread * rng.standard_normal(x.shape), x.dtype)

    return jax.tree_util.tree_map_with_path(move, params)


def _without_noise_grads(grads):
    """JAX training draws the decoder's noise from a key, so its stored noise
    leaves get zero gradients; the deterministic forwards here read them,
    so their gradients are zeroed as training leaves them."""
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.zeros_like(x) if _is_noise(jax.tree_util.keystr(p)) else x, grads)


def _filled(params, moments):
    """An optax mask's moments with zeros for its masked leaves."""
    return jax.tree_util.tree_map(
        lambda p, m: np.zeros_like(p) if isinstance(m, optax.MaskedNode) else m, params, moments)


def _assert_close(module, want, saved, what):
    """Every parameter of ``module`` against JAX's after the resumed steps
    (``want``): within ``PARAM_RTOL`` of the tensor's largest value plus
    ``STEP_RTOL`` of the largest change JAX's steps made to it since the
    save (``saved``).  The second term is the float32 agreement of the two
    packages' gradients (the repository's bar for them: 1e-3 of their
    norm), which Adam carries into its steps; it decides only for tensors
    whose values are a few steps in size (the decoder's noise weights)."""
    worst = 0.0
    for name, p in module.named_parameters():
        w, s0 = want[name].float(), saved[name].float()
        err = (p.detach().float() - w).abs().max().item()
        bound = PARAM_RTOL * w.abs().max().item() + STEP_RTOL * (w - s0).abs().max().item()
        assert err <= bound + 1e-12, (what, name, err, bound)
        worst = max(worst, err / (w.abs().max().item() + 1e-30))
    print(f"{what}: largest difference {worst:.3g} of a tensor's max")


def _assert_equal_sd(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def _export_import(tmp_path, run, configs):
    """Export the JAX run directory ``run`` and import it; returns the port's out_base."""
    export_run(str(run), str(tmp_path / "export"))
    out = tmp_path / "port"
    checkpoints.import_jax_run(str(tmp_path / "export"), str(out), configs)
    return out


# --------------------------------------------------------------- the archive
def test_export_round_trip_is_bit_equal(tmp_path):
    """f32, int and python-scalar leaves, a bf16 leaf, ``None`` leaves and
    list-indexed chains (optax's adam, a masked multi_transform) come back
    as orbax restores them, bit for bit, the ``None`` leaves left out."""
    rng = np.random.default_rng(0)
    params = {"decoder": {"w": jnp.asarray(rng.standard_normal((3, 4)), jnp.float32),
                          "l": [jnp.ones(2), jnp.zeros(1)]},
              "mapping": {"w": jnp.asarray(rng.standard_normal(5), jnp.float32)}}
    adam = optax.adam(1e-3)
    masked = j_optim.decoder_only(adam, params)
    _, adam_state = _random_updates(adam, params, adam.init(params), 2, 1)
    _, masked_state = _random_updates(masked, params, masked.init(params), 2, 2)
    tree = {"params": params, "adam": adam_state, "masked": masked_state, "step": 7,
            "scale": 0.25, "count": jnp.asarray(3, jnp.int32),
            "bf": jnp.asarray(rng.standard_normal(6), jnp.bfloat16), "empty": None}
    j_ckpt.save_checkpoint(str(tmp_path / "run"), "models_0000007", tree)
    ref = j_ckpt.load_checkpoint(str(tmp_path / "run"), "models_0000007")
    assert export_run(str(tmp_path / "run"), str(tmp_path / "x")) == ["models_0000007.npz"]
    got = read_export(str(tmp_path / "x" / "models_0000007.npz"))

    def kept(v):  # a subtree with a leaf that is not None: the archive keeps it
        if isinstance(v, dict):
            return any(kept(x) for x in v.values())
        if isinstance(v, (list, tuple)):
            return any(kept(x) for x in v)
        return v is not None

    def walk(r, g, path):
        if isinstance(r, dict):
            assert set(g) == {k for k, v in r.items() if kept(v)}, path
            for k, v in r.items():
                if kept(v):
                    walk(v, g[k], f"{path}/{k}")
        elif isinstance(r, (list, tuple)):
            idx = [i for i, v in enumerate(r) if kept(v)]
            assert isinstance(g, list) and len(g) == idx[-1] + 1, path
            for i in range(len(g)):
                if kept(r[i]):
                    walk(r[i], g[i], f"{path}/{i}")
                else:
                    assert g[i] is None, path
        else:
            r = np.asarray(r)
            if r.dtype.name == "bfloat16":
                assert g.dtype == torch.bfloat16
                assert np.array_equal(g.view(torch.int16).numpy(), r.view(np.int16)), path
            else:
                assert g.dtype == r.dtype and g.shape == r.shape, path
                assert np.array_equal(g, r), path

    walk(ref, got, "")
    assert got["step"].shape == () and int(got["step"]) == 7
    assert got["adam"][0]["mu"]["decoder"]["l"][1].shape == (1,)
    assert "mapping" not in got["masked"]["inner_states"]["train"]["inner_state"][0]["mu"]


# ------------------------------------------------------- every kind, exactly
def _opt_state_of(opt_sd, module, opt):
    """{parameter name: its state} of a port optimizer's state dict."""
    names = {id(p): n for n, p in module.named_parameters()}
    order = [names[id(p)] for group in opt.param_groups for p in group["params"]]
    assert sorted(opt_sd["state"]) == list(range(len(order)))
    return {order[i]: s for i, s in opt_sd["state"].items()}


def _save_all(run, trees):
    for rel, tree in trees.items():
        j_ckpt.save_checkpoint(str(run / os.path.dirname(rel)), os.path.basename(rel), tree)


@pytest.fixture(scope="module")
def stage_a_run(tmp_path_factory):
    """A JAX stage-A run (lazy R1 every 2nd iteration) saved by JAX's
    ``save_checkpoint``: ``sdf_init_models``, ``models_0000002`` (weights
    off their init, Adam states after 3 updates) and ``vol_renderer``;
    exported and imported."""
    tmp = tmp_path_factory.mktemp("stage_a")
    jcfg, pcfg = _configs_a()
    vrd_j, vrd_p = j_disc.VolumeRenderDiscConfig(in_res=RES), \
        discriminator.VolumeRenderDiscConfig(in_res=RES)
    hp_j = j_steps.TrainHParams(batch=BATCH, style_dim=STYLE, a_d_reg_every=2)
    hp_p = steps.TrainHParams(batch=BATCH, style_dim=STYLE, a_d_reg_every=2)
    g0 = j_gen.init_generator(jax.random.PRNGKey(0), jcfg)
    d0 = j_disc.init_volume_render_discriminator(jax.random.PRNGKey(5), vrd_j)
    g_tx, d_tx = j_optim.stage_a_optimizers(2)
    g, g_st = _random_updates(g_tx, _trained(g0, 1), g_tx.init(g0), 3, 1)
    d, d_st = _random_updates(d_tx, _trained(d0, 2), d_tx.init(d0), 3, 2)
    g_ema = _trained(g, 3, 0.01)
    trees = {"volume_renderer/sdf_init_models": {"g": g0, "g_ema": g0},
             "volume_renderer/models_0000002": {"g": g, "d": d, "g_ema": g_ema, "g_opt": g_st,
                                                "d_opt": d_st, "step": 2},
             "volume_renderer/vol_renderer": {"g": g, "d": d, "g_ema": g_ema}}
    _save_all(tmp / "run", trees)
    configs = checkpoints.RunConfigs(stage_a=(pcfg, vrd_p, hp_p), stage_b=None, vae=None,
                                     psp=None)
    out = _export_import(tmp, tmp / "run", configs)
    return dict(run=tmp / "run", out=out, trees=trees, configs=configs, jcfg=jcfg, pcfg=pcfg,
                dcfg_j=vrd_j, dcfg_p=vrd_p, hp_j=hp_j, hp_p=hp_p, g0=g0, d0=d0, g_tx=g_tx,
                d_tx=d_tx)


@pytest.fixture(scope="module")
def stage_b_run(tmp_path_factory):
    """A JAX stage-B run (the decoder-only G Adam; lazy R1 and path length
    every 2nd iteration): ``models_0000004`` (noise moments zero, as
    training leaves them) and ``full_pipeline``; exported and imported."""
    tmp = tmp_path_factory.mktemp("stage_b")
    jcfg, pcfg = _configs_b()
    sd_j = j_disc.StyleDiscConfig(size=32, channel_multiplier=1, channel_base=32)
    sd_p = discriminator.StyleDiscConfig(size=32, channel_multiplier=1, channel_base=32)
    hkw = dict(batch=BATCH, style_dim=STYLE, g_reg_every=2, d_reg_every=2)
    hp_j, hp_p = j_steps.TrainHParams(**hkw), steps.TrainHParams(**hkw)
    g0 = j_gen.init_generator(jax.random.PRNGKey(20), jcfg)
    d0 = j_disc.init_style_discriminator(jax.random.PRNGKey(21), sd_j)
    g_tx, d_tx = j_optim.stage_b_optimizers(g_reg_every=2, d_reg_every=2)
    g_tx = j_optim.decoder_only(g_tx, g0)
    g, g_st = _random_updates(g_tx, _trained(g0, 1), g_tx.init(g0), 3, 1, frozen=_is_noise)
    d, d_st = _random_updates(d_tx, _trained(d0, 2), d_tx.init(d0), 3, 2)
    g_ema = _trained(g, 3, 0.01)
    trees = {"models_0000004": {"g": g, "d": d, "g_ema": g_ema, "g_opt": g_st, "d_opt": d_st,
                                "step": 4, "mean_path_length": jnp.asarray(0.375)},
             "full_pipeline": {"g": g, "d": d, "g_ema": g_ema}}
    _save_all(tmp / "run", trees)
    configs = checkpoints.RunConfigs(stage_a=None, stage_b=(pcfg, sd_p, hp_p), vae=None,
                                     psp=None)
    out = _export_import(tmp, tmp / "run", configs)
    return dict(run=tmp / "run", out=out, trees=trees, configs=configs, jcfg=jcfg, pcfg=pcfg,
                dcfg_j=sd_j, dcfg_p=sd_p, hp_j=hp_j, hp_p=hp_p, g0=g0, d0=d0, g_tx=g_tx,
                d_tx=d_tx)


@pytest.mark.parametrize("rel", ["volume_renderer/sdf_init_models",
                                 "volume_renderer/models_0000002",
                                 "volume_renderer/vol_renderer", "models_0000004",
                                 "full_pipeline"])
def test_each_kind_imports_to_the_converters(request, rel):
    """Parameters as the converters give them; Adam's moments through the
    same converters (stage B's decoder-only moments with the frozen leaves
    absent, the noise moments dropped) with step = count; the port
    optimizers' own param_groups (the lazy-regularisation betas); ``step``
    and ``mean_path_length``.  (Stage C's kinds:
    ``test_stage_c_resumes_as_jax_continues``.)"""
    stage_a = rel.startswith("volume_renderer")
    run = request.getfixturevalue("stage_a_run" if stage_a else "stage_b_run")
    tree, pcfg = run["trees"][rel], run["pcfg"]
    ck = _port_resume(run["out"], rel)
    for k in ("g", "g_ema"):
        _assert_equal_sd(ck[k], jax_params_to_state_dict(tree[k], pcfg))
    if "d" in tree:
        _assert_equal_sd(ck["d"], jax_disc_params_to_state_dict(tree["d"]))
    if "g_opt" not in tree:
        assert set(ck) == set(tree)
        return
    hp = run["hp_p"]
    g = Generator(pcfg, device="cpu")
    d = (discriminator.VolumeRenderDiscriminator if stage_a else
         discriminator.StyleDiscriminator)(run["dcfg_p"])
    if stage_a:
        g_opt, d_opt = optim.stage_a_optimizers(g, d, hp.a_d_reg_every)
        g_adam = tree["g_opt"][0]
        mu = jax_params_to_state_dict(g_adam.mu, pcfg)
    else:
        g_opt, d_opt = optim.stage_b_optimizers(g, d, lr=2e-3, g_reg_every=hp.g_reg_every,
                                                d_reg_every=hp.d_reg_every)
        g_adam = tree["g_opt"].inner_states["train"].inner_state[0]
        mu = jax_params_to_state_dict(_filled(tree["g"], g_adam.mu), pcfg)
        assert float(ck["mean_path_length"]) == 0.375
    g_state = _opt_state_of(ck["g_opt"], g, g_opt)
    if not stage_a:
        assert set(g_state) == {n for n, _ in g.named_parameters() if n.startswith("decoder.")}
    for n, s in g_state.items():
        assert float(s["step"]) == float(g_adam.count) == 3.0
        assert torch.equal(s["exp_avg"], mu[n]), n
    d_mu = jax_disc_params_to_state_dict(tree["d_opt"][0].mu)
    for n, s in _opt_state_of(ck["d_opt"], d, d_opt).items():
        assert torch.equal(s["exp_avg"], d_mu[n]), n
    for name, opt in (("g_opt", g_opt), ("d_opt", d_opt)):
        assert ck[name]["param_groups"] == opt.state_dict()["param_groups"], name
    assert ck["step"] == tree["step"]


def test_a_decoder_without_convs_crosses(tmp_path):
    """A decoder at its input's resolution holds no convs: the empty lists,
    which an export cannot hold, are not needed to import it."""
    jcfg, pcfg = _configs_b()
    jcfg, pcfg = replace(jcfg, size=RES), replace(pcfg, size=RES)
    g = j_gen.init_generator(jax.random.PRNGKey(3), jcfg)
    assert g["decoder"]["convs"] == []
    sd_j = j_disc.StyleDiscConfig(size=RES, channel_multiplier=1, channel_base=32)
    sd_p = discriminator.StyleDiscConfig(size=RES, channel_multiplier=1, channel_base=32)
    j_ckpt.save_checkpoint(str(tmp_path / "run"), "full_pipeline",
                           {"g": g, "d": j_disc.init_style_discriminator(
                               jax.random.PRNGKey(4), sd_j), "g_ema": g})
    out = _export_import(tmp_path, tmp_path / "run", checkpoints.RunConfigs(
        stage_a=None, stage_b=(pcfg, sd_p, None), vae=None, psp=None))
    ck = _port_resume(out, "full_pipeline")
    _assert_equal_sd(ck["g_ema"], jax_params_to_state_dict(g, pcfg))
    Generator(pcfg, device="cpu").load_state_dict(ck["g_ema"])


# -------------------------------------------------------- resume equivalence
def _jax_resume(run, rel, template):
    """The JAX loop's restore: ``load_checkpoint`` with its templates."""
    return j_ckpt.load_checkpoint(str(run / os.path.dirname(rel)), os.path.basename(rel),
                                  template)


def _port_resume(out, rel):
    return checkpoints.load_checkpoint(str(out / os.path.dirname(rel)), os.path.basename(rel))


def _port_modules(pck, g, d, g_ema):
    """The port loop's restore of a stage-A/B ``models_*`` into modules."""
    g.load_state_dict(pck["g"])
    d.load_state_dict(pck["d"])
    g_ema.requires_grad_(False).load_state_dict(pck["g_ema"])
    return g, d, g_ema


def _resumed(run, rel, port_d):
    """Both packages' restores of ``rel``, as their loops restore it: JAX's
    state tree, and the port's modules and optimizers."""
    g0, d0, g_tx, d_tx = run["g0"], run["d0"], run["g_tx"], run["d_tx"]
    template = {"g": g0, "d": d0, "g_ema": g0, "g_opt": g_tx.init(g0), "d_opt": d_tx.init(d0),
                "step": 0}
    if "mean_path_length" in run["trees"][rel]:
        template["mean_path_length"] = jnp.zeros(())
    ck = _jax_resume(run["run"], rel, template)
    pck = _port_resume(run["out"], rel)
    pcfg, hp = run["pcfg"], run["hp_p"]
    pg, pd, pg_ema = _port_modules(pck, Generator(pcfg, device="cpu"), port_d,
                                   Generator(pcfg, device="cpu"))
    if isinstance(pd, discriminator.VolumeRenderDiscriminator):
        g_opt, d_opt = optim.stage_a_optimizers(pg, pd, hp.a_d_reg_every)
    else:
        g_opt, d_opt = optim.stage_b_optimizers(pg, pd, lr=2e-3, g_reg_every=hp.g_reg_every,
                                                d_reg_every=hp.d_reg_every)
    g_opt.load_state_dict(pck["g_opt"])
    d_opt.load_state_dict(pck["d_opt"])
    assert int(ck["step"]) == int(pck["step"])
    return ck, pck, (pg, pd, pg_ema, g_opt, d_opt)


def test_stage_a_resumes_as_jax_continues(stage_a_run):
    """Saved at step 2, both resume at 3 and take iterations 3 (plain D)
    and 4 (R1 D, the ratio-adjusted Adam), each D, then G, then the EMA."""
    run = stage_a_run
    jcfg, pcfg, vrd_j, vrd_p = run["jcfg"], run["pcfg"], run["dcfg_j"], run["dcfg_p"]
    hp_j, hp_p, g_tx, d_tx = run["hp_j"], run["hp_p"], run["g_tx"], run["d_tx"]
    rel = "volume_renderer/models_0000002"
    ck, pck, (pg, pd, pg_ema, g_opt, d_opt) = _resumed(
        run, rel, discriminator.VolumeRenderDiscriminator(vrd_p))
    g, d, g_ema, g_st, d_st = ck["g"], ck["d"], ck["g_ema"], ck["g_opt"], ck["d_opt"]
    start = int(ck["step"]) + 1
    assert start == 3

    def d_loss(dp, gp, z, jc, real, with_r1):
        fake = jax.lax.stop_gradient(j_gen.generator_forward(
            gp, jcfg, [z], jc.extrinsics, jc.focal, jc.near, jc.far).thumb_rgb)
        fake_pred, fake_view = j_disc.apply_volume_render_discriminator(dp, vrd_j, fake)
        apply = lambda img: j_disc.apply_volume_render_discriminator(dp, vrd_j, img)[0]  # noqa: E731
        if with_r1:  # make_stage_a_d_step's R1, times the lazy interval
            real_pred, pen = j_gan.d_logits_and_r1(apply, real)
            r1 = hp_j.r1 * 0.5 * pen * hp_j.a_d_reg_every
        else:
            real_pred, r1 = apply(real), 0.0
        return (j_gan.d_logistic_loss(real_pred, fake_pred) + r1
                + hp_j.view_lambda * j_gan.viewpoints_loss(fake_view, jc.viewpoint))

    jd = _jit(jax.value_and_grad(d_loss), static_argnums=5)
    jg = _jit(lambda gp, dp, z, jc: jax.value_and_grad(
        _jax_stage_a_g_loss(jcfg, vrd_j, hp_j, dp, z, jc), has_aux=True)(gp))
    g_step, d_step = _stepper(g_tx), _stepper(d_tx)
    saved = (jax_params_to_state_dict(g, pcfg), jax_disc_params_to_state_dict(d),
             jax_params_to_state_dict(g_ema, pcfg))
    rng = np.random.default_rng(40)
    for i in (start, start + 1):
        jc, pc = _cams(seed=60 + i)
        z_d, z_g = _z(seed=70 + i), _z(seed=80 + i)
        real = rng.uniform(-1, 1, (BATCH, RES, RES, 3)).astype(np.float32)
        with_r1 = i % hp_j.a_d_reg_every == 0
        jl, grads = jd(d, g, jnp.asarray(z_d), jc, jnp.asarray(real), with_r1)
        d, d_st = d_step(grads, d_st, d)
        loss, _ = steps.stage_a_d_loss(pg, pd, pcfg, vrd_p, hp_p, _t(real),
                                       steps.StepInputs(_t(z_d), pc), with_r1=with_r1)
        steps._step(d_opt, loss)
        np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
        (jl, _), grads = jg(g, d, jnp.asarray(z_g), jc)
        g, g_st = g_step(grads, g_st, g)
        g_ema = j_ema.accumulate(g_ema, g)
        loss, _ = steps.stage_a_g_loss(pg, pd, pcfg, vrd_p, hp_p, steps.StepInputs(_t(z_g), pc))
        steps._step(g_opt, loss)
        ema.accumulate(pg_ema, pg)
        np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    _assert_close(pg, jax_params_to_state_dict(g, pcfg), saved[0], "g")
    _assert_close(pd, jax_disc_params_to_state_dict(d), saved[1], "d")
    _assert_close(pg_ema, jax_params_to_state_dict(g_ema, pcfg), saved[2], "g_ema")


def test_stage_b_resumes_as_jax_continues(stage_b_run):
    """Saved at step 4, both resume at 5 (plain D, G) and take 6 (R1 D, G,
    path length with the decoder-only Adam), the EMA after each;
    ``mean_path_length`` carried."""
    run = stage_b_run
    jcfg, pcfg, sd_j, sd_p = run["jcfg"], run["pcfg"], run["dcfg_j"], run["dcfg_p"]
    hp_j, hp_p, g_tx, d_tx = run["hp_j"], run["hp_p"], run["g_tx"], run["d_tx"]
    ck, pck, (pg, pd, pg_ema, g_opt, d_opt) = _resumed(
        run, "models_0000004", discriminator.StyleDiscriminator(sd_p))
    g, d, g_ema, g_st, d_st = ck["g"], ck["d"], ck["g_ema"], ck["g_opt"], ck["d_opt"]
    mean, pmean = ck["mean_path_length"], pck["mean_path_length"]
    start = int(ck["step"]) + 1
    assert start == 5
    idx = 2

    def fwd(gp, z1, z2, jc):
        return j_gen.generator_forward(gp, jcfg, [z1, z2], jc.extrinsics, jc.focal, jc.near,
                                       jc.far, inject_index=idx)

    def d_loss(dp, gp, z1, z2, jc, real, regularize):
        fake = jax.lax.stop_gradient(fwd(gp, z1, z2, jc).rgb)
        apply = lambda img: j_disc.apply_style_discriminator(dp, sd_j, img)  # noqa: E731
        if regularize:
            real_pred, pen = j_gan.d_logits_and_r1(apply, real)
            r1 = hp_j.r1 * 0.5 * pen * hp_j.d_reg_every
        else:
            real_pred, r1 = apply(real), 0.0
        return j_gan.d_logistic_loss(real_pred, apply(fake)) + r1

    def g_loss(gp, dp, z1, z2, jc):
        out = fwd(gp, z1, z2, jc)
        up = jnp.repeat(jnp.repeat(out.thumb_rgb, 4, axis=1), 4, axis=2)
        return (j_gan.g_nonsaturating_loss(j_disc.apply_style_discriminator(dp, sd_j, out.rgb))
                + 0.001 * j_gan.g_content_loss(out.rgb, up))

    def path_loss(gp, z1, z2, jc, m, noise):
        dec = jcfg.decoder
        feat = jax.lax.stop_gradient(j_rend.render(
            gp["renderer"], jcfg.renderer, jc.focal, jc.extrinsics, jc.near, jc.far,
            j_gen.map_style(gp, z1)).features)
        latent = j_sg.make_decoder_latent(gp["decoder"], dec, [j_gen.map_style(gp, z1),
                                                               j_gen.map_style(gp, z2)],
                                          inject_index=idx)
        pen, new_mean, _ = j_gan.g_path_regularize(
            lambda lat: j_sg.apply_decoder(gp["decoder"], dec, feat, lat), latent, m,
            noise=noise)
        return hp_j.path_regularize * hp_j.g_reg_every * pen, new_mean

    jd = _jit(jax.value_and_grad(d_loss), static_argnums=6)
    jgl = _jit(jax.value_and_grad(g_loss))
    jpl = _jit(jax.value_and_grad(path_loss, has_aux=True))
    g_step, d_step = _stepper(g_tx), _stepper(d_tx)
    saved = (jax_params_to_state_dict(g, pcfg), jax_disc_params_to_state_dict(d),
             jax_params_to_state_dict(g_ema, pcfg))
    rng = np.random.default_rng(41)
    for i in (start, start + 1):
        jc, pc = _cams(seed=60 + i)
        z1, z2 = _z(seed=70 + i), _z(seed=80 + i)
        real = rng.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32)
        noise = (rng.standard_normal((BATCH, 32, 32, 3)) / 32.0).astype(np.float32)
        inputs = steps.StepInputs(_t(z1), pc, _t(z2), idx, path_noise=_t(noise))
        jz = (jnp.asarray(z1), jnp.asarray(z2), jc)
        reg = i % hp_j.d_reg_every == 0
        jl, grads = jd(d, g, *jz, jnp.asarray(real), reg)
        d, d_st = d_step(grads, d_st, d)
        loss, _ = steps.stage_b_d_loss(pg, pd, pcfg, sd_p, hp_p, _t(real), inputs, reg)
        steps._step(d_opt, loss)
        np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
        jl, grads = jgl(g, d, *jz)
        g, g_st = g_step(_without_noise_grads(grads), g_st, g)
        loss, _ = steps.stage_b_g_loss(pg, pd, pcfg, sd_p, hp_p, inputs)
        steps._step(g_opt, loss)
        np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
        if i % hp_j.g_reg_every == 0:
            (jl, mean), grads = jpl(g, *jz, mean, jnp.asarray(noise))
            g, g_st = g_step(_without_noise_grads(grads), g_st, g)
            loss, pmean, _ = steps.stage_b_path_loss(pg, pcfg, hp_p, inputs, pmean)
            steps._step(g_opt, loss)
            np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
            np.testing.assert_allclose(pmean.item(), float(mean), rtol=1e-5)
        g_ema = j_ema.accumulate(g_ema, g)
        ema.accumulate(pg_ema, pg)
    _assert_close(pg, jax_params_to_state_dict(g, pcfg), saved[0], "g")
    _assert_close(pd, jax_disc_params_to_state_dict(d), saved[1], "d")
    _assert_close(pg_ema, jax_params_to_state_dict(g_ema, pcfg), saved[2], "g_ema")


@pytest.mark.parametrize("kind", ["vae", "psp"])
def test_stage_c_resumes_as_jax_continues(tmp_path, kind):
    """Stage C's kinds and their resume: ``models_*`` (Adam for the VAE;
    Ranger for pSp: RAdam's moments, the slow weights and the step) and the
    ``encoder`` artifact import to exactly the converters' output; then the
    VAE (saved at step 2 after 3 updates, two more steps with JAX's eps)
    and pSp (saved at step 4 with a Ranger state at count 5, so the next
    three cross RAdam's rectification switch at count 6 and lookahead's
    sync at 6) continue against a frozen generator as JAX continues."""
    psp = kind == "psp"
    jcfg, pcfg = _gcfgs(256, 16, channel_base=32) if psp else _gcfgs(16, 16)
    gp, g = _generators(jcfg, pcfg)
    g.requires_grad_(False)
    if psp:
        jecfg = j_psp.PSPConfig(img_size=16, style_count=jcfg.decoder.n_latent,
                                renderer_style_dim=256)
        pecfg = encoder.PSPConfig(img_size=16, style_count=jcfg.decoder.n_latent,
                                  renderer_style_dim=256)
    else:
        jecfg, pecfg = j_vae.VAEEncoderConfig(img_size=16, z_size=16), \
            encoder.VAEEncoderConfig(img_size=16, z_size=16)
    to_sd = jax_psp_params_to_state_dict if psp else jax_vae_params_to_state_dict
    e0 = _host(_jit(j_psp.init_psp_encoder if psp else j_vae.init_vae_encoder,
                    static_argnums=1)(jax.random.PRNGKey(2), jecfg))
    tx = j_optim.encoder_optimizer(vae=not psp)
    if psp:  # a Ranger state at count 5: the updates themselves would cost a minute here
        e, rng = _trained(e0, 3), np.random.default_rng(4)
        st = tx.init(e)
        radam = st["inner"][1][0]._replace(
            count=jnp.asarray(5, jnp.int32),
            mu=jax.tree_util.tree_map(lambda x: jnp.asarray(
                1e-3 * rng.standard_normal(x.shape), x.dtype), e),
            nu=jax.tree_util.tree_map(lambda x: jnp.asarray(
                1e-6 * rng.standard_normal(x.shape) ** 2, x.dtype), e))
        st = {"inner": (st["inner"][0], (radam, st["inner"][1][1])),
              "slow": _trained(e, 5, 0.01), "step": jnp.asarray(5, jnp.int32)}
    else:
        e, st = _random_updates(tx, _trained(e0, 3), tx.init(e0), 3, 3)
    saved = 4 if psp else 2
    sub = "encoder_psp" if psp else "encoder"
    rel = f"{sub}/models_{saved:07d}"
    run = tmp_path / "run"
    j_ckpt.save_checkpoint(str(run / sub), f"models_{saved:07d}",
                           {"e": e, "e_opt": st, "step": saved})
    if not psp:  # the artifact's import differs from pSp's only by the converter
        j_ckpt.save_checkpoint(str(run / sub), "encoder", {"e": e, "g_ema": gp})
    out = _export_import(tmp_path, run, checkpoints.RunConfigs(
        stage_a=None, stage_b=(pcfg, None, None), vae=None if psp else pecfg,
        psp=pecfg if psp else None))

    if not psp:
        art = _port_resume(out, f"{sub}/encoder")
        _assert_equal_sd(art["e"], to_sd(e))
        _assert_equal_sd(art["g_ema"], jax_params_to_state_dict(gp, pcfg))
    pck = _port_resume(out, rel)
    _assert_equal_sd(pck["e"], to_sd(e))
    pe = encoder.PSPEncoder(pecfg) if psp else encoder.VAEEncoder(pecfg)
    opt = optim.encoder_optimizer(pe.parameters(), vae=not psp)
    state = _opt_state_of(pck["e_opt"], pe, opt)
    if psp:
        radam = st["inner"][1][0]
        want = {"mu": to_sd(radam.mu), "nu": to_sd(radam.nu), "slow": to_sd(st["slow"])}
        assert int(radam.count) == int(st["step"]) == 5
        assert all(s["step"] == 5 for s in state.values())
    else:
        want = {"exp_avg": to_sd(st[0].mu), "exp_avg_sq": to_sd(st[0].nu)}
        assert all(float(s["step"]) == 3.0 for s in state.values())
    for n, s in state.items():
        for k, sd in want.items():
            assert torch.equal(s[k], sd[n]), (n, k)
    assert pck["e_opt"]["param_groups"] == opt.state_dict()["param_groups"]

    ck = _jax_resume(run, rel, {"e": e0, "e_opt": tx.init(e0), "step": 0})
    e, st = _host(ck["e"]), _host(ck["e_opt"])
    pe.load_state_dict(pck["e"])
    opt.load_state_dict(pck["e_opt"])
    start = int(ck["step"]) + 1
    assert start == int(pck["step"]) + 1 == saved + 1
    rng = np.random.default_rng(6)
    avg = (0.1 * rng.standard_normal((1, 256)).astype(np.float32),
           0.1 * rng.standard_normal((1, 512)).astype(np.float32)) if psp else None
    loss_j = _jit(jax.value_and_grad(_jax_loss), static_argnums=(2, 3, 4))
    e_step = _stepper(tx)
    j_loss_utils = j_losses.LossUtils()
    saved = to_sd(e)
    for i in range(start, start + (3 if psp else 2)):
        imgs, thumbs = _images(10 + i, BATCH, 16), _images(20 + i, BATCH, 8)
        jc = j_cams(8, jax.random.PRNGKey(30 + i), batch=BATCH)
        eps = None if psp else np.asarray(jax.random.normal(jax.random.PRNGKey(40 + i),
                                                            (BATCH, 16)))
        kw = (dict(latent_avg=tuple(map(jnp.asarray, avg))) if psp
              else dict(eps=jnp.asarray(eps)))
        jl, grads = loss_j(e, gp, jcfg, jecfg, j_loss_utils, jnp.asarray(imgs),
                           jnp.asarray(thumbs), jc, **kw)
        e, st = e_step(grads, st, e)
        inputs = encoder_loop.EncoderInputs(_t(imgs), _t(thumbs), CameraParams(*map(_t, jc)),
                                            eps=None if psp else _t(eps))
        loss, _ = encoder_loop.encoder_loss(pe, g, pcfg, pecfg, encoder.LossUtils(), inputs,
                                            latent_avg=tuple(map(_t, avg)) if psp else None)
        steps._step(opt, loss)
        np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    _assert_close(pe, to_sd(e), saved, kind)
    if psp:
        assert int(st["step"]) == 8 and all(s["step"] == 8 for s in opt.state.values())
        slow = to_sd(st["slow"])
        names = {id(p): n for n, p in pe.named_parameters()}
        for p, s in opt.state.items():
            w = slow[names[id(p)]]
            assert (s["slow"] - w).abs().max().item() <= PARAM_RTOL * w.abs().max().item() + 1e-12


# ----------------------------------------------------------- the flagship
def test_flagship_width_stage_b_checkpoint_imports_bit_exact(tmp_path):
    """``configs/256res/ffhq_256_sdf_tpu.yaml`` at full width: a JAX-built
    stage-B ``models_*`` (the generator's 7.84 M parameters, the StyleGAN2
    D, the decoder-only Adam after one update) -> orbax -> export -> import,
    every tensor bit-equal to the converters' output."""
    from sdface_gan_tpu.config.build import discriminator_configs, generator_config
    from sdface_gan_tpu.config.sdf_options import get_vol_render_opt, rendering_overrides

    yaml = str(REPO / "configs" / "256res" / "ffhq_256_sdf_tpu.yaml")
    jcfg_all = j_load_config(yaml, default_config_path())
    opt = get_vol_render_opt(jcfg_all["training"]["out_dir"].split("/")[1], False,
                             size=jcfg_all["data"].get("img_size", 256),
                             extra_argv=rendering_overrides(jcfg_all))
    jcfg, sd_j = generator_config(opt, stage_a=False), discriminator_configs(opt)[1]
    g = j_gen.init_generator(jax.random.PRNGKey(0), jcfg)
    assert sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(g)) > 7_000_000
    d = j_disc.init_style_discriminator(jax.random.PRNGKey(1), sd_j)
    g_tx, d_tx = j_optim.stage_b_optimizers()
    g_tx = j_optim.decoder_only(g_tx, g)
    g1, g_st = _random_updates(g_tx, g, g_tx.init(g), 1, 2, frozen=_is_noise)
    tree = {"g": g1, "d": d, "g_ema": g, "g_opt": g_st, "d_opt": d_tx.init(d), "step": 10000,
            "mean_path_length": jnp.asarray(0.5)}
    j_ckpt.save_checkpoint(str(tmp_path / "run"), "models_0010000", tree)
    del g, d
    cfg = load_config(yaml, port_default())
    pcfg, sd_p, hp = stage_configs(cfg, False)
    assert pcfg.renderer.width == jcfg.renderer.width and pcfg.size == jcfg.size
    out = _export_import(tmp_path, tmp_path / "run", checkpoints.RunConfigs(
        stage_a=None, stage_b=(pcfg, sd_p, hp), vae=None, psp=None))
    ck = _port_resume(out, "models_0010000")
    _assert_equal_sd(ck["g"], jax_params_to_state_dict(g1, pcfg))
    _assert_equal_sd(ck["d"], jax_disc_params_to_state_dict(tree["d"]))
    mu = jax_params_to_state_dict(_filled(g1, g_st.inner_states["train"].inner_state[0].mu),
                                  pcfg)
    pg = Generator(pcfg, device="cpu")
    g_opt, d_opt = optim.stage_b_optimizers(pg, discriminator.StyleDiscriminator(sd_p))
    state = _opt_state_of(ck["g_opt"], pg, g_opt)
    assert len(state) == len(list(optim.decoder_only(pg)))
    for n, s in state.items():
        assert torch.equal(s["exp_avg"], mu[n]), n
    assert ck["step"] == 10000 and float(ck["mean_path_length"]) == 0.5


# --------------------------------------------------- the committed fixture
@pytest.fixture(scope="module")
def fixture_configs():
    """The fixture's configs as the port's train entry builds them from its
    yaml, stage B's channel table shrunk as the fixture script shrank it."""
    cfg = load_config(str(FIXTURE / "jax_bridge.yaml"), port_default())
    with np.load(FIXTURE / "samples.npz") as s:
        samples = {k: s[k] for k in s.files}
    cb = int(samples["channel_base"])
    gcfg, sd, hp = stage_configs(cfg, False)
    stage_b = (replace(gcfg, channel_base=cb), replace(sd, channel_base=cb), hp)
    size = cfg["data"]["img_size"]
    return dict(samples=samples, configs=checkpoints.RunConfigs(
        stage_a=stage_configs(cfg, True), stage_b=stage_b,
        vae=encoder_config(stage_b[0], size, False), psp=encoder_config(stage_b[0], size, True)))


def test_fixture_images_are_jaxs_forward_of_its_params(fixture_configs):
    """Guards against a stale fixture: JAX's forward of the exported
    ``full_pipeline`` g_ema gives the stored images."""
    from sdface_gan_tpu.config.build import generator_config
    from sdface_gan_tpu.config.sdf_options import get_vol_render_opt, rendering_overrides

    s = fixture_configs["samples"]
    cfg = j_load_config(str(FIXTURE / "jax_bridge.yaml"), default_config_path())
    opt = get_vol_render_opt("jax_bridge", False, size=cfg["data"]["img_size"], batch=2,
                             extra_argv=rendering_overrides(cfg))
    jcfg = replace(generator_config(opt, stage_a=False), channel_base=int(s["channel_base"]))
    g_ema = jax.tree_util.tree_map(jnp.asarray, read_export(
        str(FIXTURE / "stage_b" / "full_pipeline.npz"))["g_ema"])
    cams = j_cams(jcfg.renderer.out_im_res, None,
                  locations=jnp.asarray([[s["azim"], s["elev"]]] * len(s["z"]), jnp.float32))
    rgb = _jit(lambda p, z, c, t: j_gen.generator_forward(
        p, jcfg, [z], c.extrinsics, c.focal, c.near, c.far, key=None,
        truncation=float(s["truncation"]), truncation_latent=t, randomize_noise=False).rgb)(
            g_ema, jnp.asarray(s["z"]), cams,
            (jnp.asarray(s["trunc_renderer"]), jnp.asarray(s["trunc_decoder"])))
    np.testing.assert_allclose(np.asarray(rgb), s["images"], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def fixture_ws(tmp_path_factory, fixture_configs):
    """The fixture imported: stage A's archive by the command line (from the
    yaml, into ./out/jax_bridge), stage B's by ``import_jax_run``."""
    ws = tmp_path_factory.mktemp("fixture")
    os.symlink(REPO / "configs", ws / "configs")
    (ws / "jax_bridge.yaml").write_text((FIXTURE / "jax_bridge.yaml").read_text())
    cwd = os.getcwd()
    os.chdir(ws)
    try:
        import_cli.main(["--src", str(FIXTURE / "stage_a"), "--config", "jax_bridge.yaml",
                         "--sdf", "1"])
        with pytest.raises(FileExistsError, match="does not overwrite"):
            import_cli.main(["--src", str(FIXTURE / "stage_a"), "--config", "jax_bridge.yaml",
                             "--sdf", "1"])
    finally:
        os.chdir(cwd)
    checkpoints.import_jax_run(str(FIXTURE / "stage_b"), str(ws / "stage_b"),
                               fixture_configs["configs"])
    return ws


def test_fixture_serves_as_jax_rendered_it(fixture_ws, fixture_configs):
    """``SDFaceSampler.from_checkpoint`` on the imported ``full_pipeline``
    with JAX's z, camera angles and truncation pair: JAX's images within
    ``IMAGE_TOL``."""
    s = fixture_configs["samples"]
    gcfg = fixture_configs["configs"].stage_b[0]
    sampler = SDFaceSampler.from_checkpoint(
        str(fixture_ws / "stage_b"), cfg=replace(gcfg, renderer=replace(gcfg.renderer,
                                                                        perturb=0.0)),
        device="cpu", batch=len(s["z"]), truncation=float(s["truncation"]),
        truncation_latent=(_t(s["trunc_renderer"]), _t(s["trunc_decoder"])))
    img = sampler.sample(z=s["z"], azim=float(s["azim"]), elev=float(s["elev"]))
    np.testing.assert_allclose(img.numpy(), s["images"], **IMAGE_TOL)


def test_fixture_trains_on_in_the_port(fixture_ws, fixture_configs, capsys, monkeypatch):
    """``train --device cpu`` starts stage A from JAX's imported
    ``sdf_init_models``; the imported stage-B ``models_0000002`` resumes
    at step 3 in ``train_full_pipeline`` (the function the entry runs; its
    yaml cannot set the fixture's channel table) and writes ``models_*``."""
    from sdface_gan_tpu_torch import prepare_data as prepare_cli
    from sdface_gan_tpu_torch import train as train_cli
    from sdface_gan_tpu_torch.data import DataLoader, MultiResolutionDataset
    from sdface_gan_tpu_torch.data.png import encode_png
    from sdface_gan_tpu_torch.training.loop import train_full_pipeline

    monkeypatch.chdir(fixture_ws)
    os.makedirs("imgs", exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(4):
        (fixture_ws / "imgs" / f"{i}.png").write_bytes(
            encode_png(rng.integers(0, 256, (36, 34, 3), dtype=np.uint8)))
    prepare_cli.main(["imgs", "--out", "store", "--size", "32", "--n_worker", "1"])
    vr = fixture_ws / "out" / "jax_bridge" / "volume_renderer"
    before = checkpoints.load_checkpoint(str(vr), "sdf_init_models")
    train_cli.main(["--config", "jax_bridge.yaml", "--sdf", "1", "--dataset_path", "store",
                    "--batch", "2", "--iters", "1", "--log_every", "1", "--save_every", "1000",
                    "--sample_every", "1000", "--device", "cpu"])
    assert "loaded sphere-initialized model" in capsys.readouterr().out
    assert checkpoints.load_checkpoint(str(vr), "sdf_init_models")["g"].keys() == \
        before["g"].keys()
    assert checkpoints.checkpoint_exists(str(vr.parent), "full_pipeline")

    gcfg, sd, hp = fixture_configs["configs"].stage_b
    ds = MultiResolutionDataset("store", resolution=32, nerf_resolution=gcfg.renderer.out_im_res)
    try:
        with DataLoader(ds, batch_size=2, seed=0) as loader:
            train_full_pipeline(loader, gcfg, sd, replace(hp, batch=2), str(fixture_ws / "stage_b"),
                                iters=5, save_every=1, sample_every=0, log_every=1,
                                device="cpu")
    finally:
        ds.close()
    assert "resumed full pipeline at step 3" in capsys.readouterr().out
    assert checkpoints.latest_checkpoint_step(str(fixture_ws / "stage_b")) == 4


def test_eval_and_sdf_mesh_run_on_an_imported_jax_run(tmp_path, monkeypatch, capsys):
    """A JAX run of the tiny yaml that ``eval`` and ``sdf_mesh`` read
    (JAX-initialized ``vol_renderer`` and ``full_pipeline``), imported by
    the command line; both tools run from it."""
    from sdface_gan_tpu.config.build import discriminator_configs, generator_config
    from sdface_gan_tpu.config.sdf_options import get_vol_render_opt, rendering_overrides
    from sdface_gan_tpu_torch import eval as eval_cli
    from sdface_gan_tpu_torch import sdf_mesh

    from test_torch_port_mesh import TINY

    (tmp_path / "tiny.yaml").write_text(TINY)
    os.symlink(REPO / "configs", tmp_path / "configs")
    cfg = j_load_config(str(tmp_path / "tiny.yaml"), default_config_path())
    exp = cfg["training"]["out_dir"].split("/")[1]
    for stage_a, rel in ((True, "volume_renderer/vol_renderer"), (False, "full_pipeline")):
        opt = get_vol_render_opt(exp, stage_a, size=cfg["data"]["img_size"],
                                 extra_argv=rendering_overrides(cfg))
        vrd, sd = discriminator_configs(opt)
        g = j_gen.init_generator(jax.random.PRNGKey(4), generator_config(opt, stage_a))
        d = (j_disc.init_volume_render_discriminator(jax.random.PRNGKey(5), vrd) if stage_a
             else j_disc.init_style_discriminator(jax.random.PRNGKey(5), sd))
        j_ckpt.save_checkpoint(str(tmp_path / "run" / os.path.dirname(rel)),
                               os.path.basename(rel), {"g": g, "d": d, "g_ema": g})
    export_run(str(tmp_path / "run"), str(tmp_path / "export"))
    monkeypatch.chdir(tmp_path)
    import_cli.main(["--src", "export", "--config", "tiny.yaml", "--sdf", "1"])
    stats = eval_cli.main(["--config", "tiny.yaml", "--n_images", "2", "--batch", "2",
                           "--no_fid", "--device", "cpu"])
    assert stats["n_images"] == 2
    sdf_mesh.main(["--config", "tiny.yaml", "--identities", "1", "--surface_res", "8",
                   "--device", "cpu"])
    assert os.listdir(tmp_path / "out" / exp / "meshes")


# ------------------------------------------------------------------ refusals
def test_refusals(tmp_path):
    """A GIRAFFE ``CheckpointIO`` tree imported with SDF configs is refused
    (it imports with ``--sdf 0``) and nothing is written; a decoder noise
    moment that is not zero raises."""
    jcfg, pcfg = _configs_b()
    g = j_gen.init_generator(jax.random.PRNGKey(0), jcfg)
    j_ckpt.CheckpointIO(str(tmp_path / "giraffe")).save("model.pt", generator=g, it=3)
    export_run(str(tmp_path / "giraffe"), str(tmp_path / "gx"))
    with pytest.raises(ValueError, match="import with --sdf 0"):
        checkpoints.import_jax_run(str(tmp_path / "gx"), str(tmp_path / "out"), None)
    assert not (tmp_path / "out").exists()

    sd = discriminator.StyleDiscConfig(size=32, channel_multiplier=1, channel_base=32)
    sd_j = j_disc.StyleDiscConfig(size=32, channel_multiplier=1, channel_base=32)
    d = j_disc.init_style_discriminator(jax.random.PRNGKey(1), sd_j)
    g_tx, d_tx = j_optim.stage_b_optimizers()
    g_tx = j_optim.decoder_only(g_tx, g)
    g1, g_st = _random_updates(g_tx, g, g_tx.init(g), 1, 3)  # noise gradients too
    j_ckpt.save_checkpoint(str(tmp_path / "b"), "models_0000001",
                           {"g": g1, "d": d, "g_ema": g, "g_opt": g_st, "d_opt": d_tx.init(d),
                            "step": 1, "mean_path_length": jnp.zeros(())})
    export_run(str(tmp_path / "b"), str(tmp_path / "bx"))
    configs = checkpoints.RunConfigs(stage_a=None, stage_b=(pcfg, sd, steps.TrainHParams()),
                                     vae=None, psp=None)
    with pytest.raises(ValueError, match="decoder.noises.noise_0.*not zero"):
        checkpoints.import_jax_run(str(tmp_path / "bx"), str(tmp_path / "out"), configs)
