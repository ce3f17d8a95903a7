"""The 64^2 recipe's bf16 G step against JAX's, on the CPU.

``configs/64res/synthetic_64_sdf_solid_eik.yaml`` trains its G with
``g_param_dtype: bfloat16``: both packages cast every float leaf of the
generator (``sigmoid_beta`` included) for the forward, the port in
``training/steps.forward_cast``, JAX in ``training/steps._cast_params``,
and the gradients come back to the f32 parameters through the casts.
The other recipe tests (``test_torch_port_training.py``) are f32.

This holds the bf16 step by the repository's bf16 contract
(``tests/test_ops.py:346-381``): each package's distance from the f32
truth (JAX's f32 step, jitted, on the same parameters and inputs) is
measured, and the port's may be no more than ``1.2 x`` JAX's own bf16
distance ``+ 1e-4``, for the loss, each term (``g``, ``g_eikonal``,
``g_minimal_surface``, ``g_sparsity``, ``fg_mass``; relative), every G
gradient (the norm of the difference over the truth's norm) and
``renderer.sigmoid_beta``'s gradient on its own.  JAX runs jitted, as the
recipe runs.

``sigmoid_beta``'s gradient is one scalar, rounded to bf16 on its way back
to the f32 parameter (the transpose of the cast), after a sum in which the
samples' terms cancel: on one draw its distance is that rounding's luck
(at the recipe's first state and the inputs of
``test_stage_a_g_loss_of_the_64_recipe_matches_jax``, JAX's jitted step
lies 4.2e-4 from f32 and JAX's op-by-op step 4.0e-3).  So every distance here is a mean
over many draws, as the contract's is a mean over many outputs: ``DRAWS``
input draws at the recipe's first state (one step), and the 20 states of
JAX's f32 trajectory of ``_RecipeTrajectory`` with each step's own inputs
(20 steps).  Both packages then run the 20 steps freely in bf16 (D and G
steps, the D's fake render in bf16 too) and beta's path in each is
printed beside JAX's f32 path.

The bar holds because the port computes what XLA's fusion computes: the
FiLM sine's argument summed in f32 (``ops/transcendental.film_sin``) and
Python scalars rounded to the tensor's dtype (``ops/fused_act.in_dtype``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from sdface_gan_tpu.losses import gan_losses as j_gan  # noqa: E402
from sdface_gan_tpu.losses import geometry_losses as j_geo  # noqa: E402
from sdface_gan_tpu.models import discriminator as j_disc  # noqa: E402
from sdface_gan_tpu.models import generator as j_gen  # noqa: E402
from sdface_gan_tpu.training import optim as j_optim  # noqa: E402
from sdface_gan_tpu.training import steps as j_steps  # noqa: E402
from sdface_gan_tpu_torch.ops.transcendental import fast_sin_lean, film_sin  # noqa: E402
from sdface_gan_tpu_torch.training import optim, steps  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import jax_params_to_state_dict  # noqa: E402
from test_torch_port_training import (  # noqa: E402,F401
    BATCH,
    STYLE,
    _cams,
    _grads,
    _port_d,
    _port_g,
    _RecipeTrajectory,
    _t,
    _two_threads,
    _z,
    recipe_trajectory,
    stage_a,
)

DRAWS = 12
TERMS = ("g", "g_eikonal", "g_minimal_surface", "g_sparsity", "fg_mass")
BETA = "renderer.sigmoid_beta"
BF16_RTOL, BF16_ATOL = 1.2, 1e-4


def _jax_g_loss(jcfg, dcfg, hp, cast):
    """The loss of ``make_stage_a_g_step`` on given inputs, the G cast to
    ``cast`` for the forward (None: f32), the sparsity term on the uncast
    beta as the step feeds it; returns (loss, metrics)."""
    def loss_fn(gp, d_params, z, jc, key):
        out = j_gen.generator_forward(j_steps._cast_params(gp, cast), jcfg, [z], jc.extrinsics,
                                      jc.focal, jc.near, jc.far, key=key, return_sdf=True,
                                      return_xyz=True, return_eikonal=True)
        fake_pred, fake_view = j_disc.apply_volume_render_discriminator(d_params, dcfg,
                                                                        out.thumb_rgb)
        g_gan = j_gan.g_nonsaturating_loss(fake_pred)
        g_view = hp.view_lambda * j_gan.viewpoints_loss(fake_view, jc.viewpoint)
        eik, msurf = j_geo.eikonal_loss(out.eikonal_term, out.sdf, beta=hp.min_surf_beta)
        sparsity = hp.sparsity_lambda * j_geo.occupancy_sparsity_loss(
            out.sdf, gp["renderer"]["sigmoid_beta"])
        loss = g_gan + g_view + hp.eikonal_lambda * eik + hp.min_surf_lambda * msurf + sparsity
        return loss, {"g": g_gan, "g_eikonal": hp.eikonal_lambda * eik,
                      "g_minimal_surface": hp.min_surf_lambda * msurf, "g_sparsity": sparsity,
                      "fg_mass": 1.0 - jnp.mean(out.mask)}
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _jax_d_loss(jcfg, dcfg, hp, cast):
    """The stage-A D loss with R1 of ``make_stage_a_d_step``, its fake
    rendered by the G cast to ``cast``."""
    def loss_fn(dp, gp, z, jc, real):
        fake = jax.lax.stop_gradient(j_gen.generator_forward(
            j_steps._cast_params(gp, cast), jcfg, [z], jc.extrinsics, jc.focal, jc.near,
            jc.far).thumb_rgb).astype(jnp.float32)
        fake_pred, fake_view = j_disc.apply_volume_render_discriminator(dp, dcfg, fake)
        d_view = hp.view_lambda * j_gan.viewpoints_loss(fake_view, jc.viewpoint)
        real_pred, pen = j_gan.d_logits_and_r1(
            lambda img: j_disc.apply_volume_render_discriminator(dp, dcfg, img)[0], real)
        return j_gan.d_logistic_loss(real_pred, fake_pred) + hp.r1 * 0.5 * pen + d_view
    return jax.jit(jax.value_and_grad(loss_fn))


def _distances(case, truth) -> dict:
    """Each quantity's distance from the truth: relative for the loss and
    the terms, the norm of the difference over the truth's norm for each
    gradient (``case`` and ``truth`` are (loss, metrics, the port's
    parameter name -> gradient))."""
    (loss, metrics, grads), (t_loss, t_metrics, t_grads) = case, truth
    out = {"loss": abs(loss - t_loss) / abs(t_loss)}
    for k in TERMS:
        out[k] = abs(metrics[k] - t_metrics[k]) / abs(t_metrics[k])
    for name, ref in t_grads.items():
        out[name] = ((grads[name] - ref).norm() / ref.norm()).item()
    return out


class _Bf16Steps:
    """The recipe's G step in JAX f32 (the truth), JAX bf16 and the port's
    bf16, on the trajectory's configs and D."""

    def __init__(self, tr: _RecipeTrajectory):
        self.tr = tr
        self.hp16 = steps.TrainHParams(batch=BATCH, style_dim=STYLE, sparsity_lambda=0.1,
                                       r1=100.0, g_param_dtype="bfloat16")
        self.truth = _jax_g_loss(tr.jcfg, tr.dcfg_j, tr.hp_j, None)
        self.jax16 = _jax_g_loss(tr.jcfg, tr.dcfg_j, tr.hp_j, jnp.bfloat16)

    def _jax(self, fn, params, d_params, z, jc, key):
        (loss, metrics), grads = fn(params, d_params, jnp.asarray(z), jc, key)
        return (float(loss), {k: float(v) for k, v in metrics.items()},
                jax_params_to_state_dict(grads, self.tr.pcfg))

    def distances(self, params, d_params, z, jc, pc, key, draws) -> dict:
        """{"jax": distances, "port": distances} at one state and input."""
        truth = self._jax(self.truth, params, d_params, z, jc, key)
        jax16 = self._jax(self.jax16, params, d_params, z, jc, key)
        g, d = _port_g(params, self.tr.pcfg), _port_d(d_params, self.tr.dcfg_p)
        loss, metrics = steps.stage_a_g_loss(g, d, self.tr.pcfg, self.tr.dcfg_p, self.hp16,
                                             steps.StepInputs(_t(z), pc, eikonal_draws=draws))
        grads = dict(zip([n for n, _ in g.named_parameters()], _grads(loss, g)))
        port = (loss.item(), {k: metrics[k].item() for k in TERMS}, grads)
        return {"jax": _distances(jax16, truth), "port": _distances(port, truth)}


def _mean(rows: list) -> dict:
    return {who: {k: float(np.mean([r[who][k] for r in rows])) for k in rows[0][who]}
            for who in ("jax", "port")}


@pytest.fixture(scope="module")
def bf16_steps(recipe_trajectory):
    tr, _ = recipe_trajectory
    return _Bf16Steps(tr)


@pytest.fixture(scope="module")
def one_step(bf16_steps):
    """Mean distances over ``DRAWS`` input draws at the recipe's first
    state (the ``stage_a`` weights)."""
    tr = bf16_steps.tr
    rows = []
    for i in range(DRAWS):
        jc, pc = _cams(seed=600 + i)
        key = jax.random.PRNGKey(700 + i)
        kuv, kt = jax.random.split(jax.random.split(jax.random.split(key)[0], 3)[2])
        draws = (_t(jax.random.uniform(kuv, (BATCH, 32, 2))),
                 _t(jax.random.uniform(kt, (BATCH, 32))))
        rows.append(bf16_steps.distances(tr.params0, tr.d_params0, _z(seed=800 + i), jc, pc,
                                         key, draws))
    return _mean(rows)


@pytest.fixture(scope="module")
def twenty_steps(bf16_steps, recipe_trajectory):
    """Mean distances over the 20 states of JAX's f32 trajectory, each with
    its own step's G inputs."""
    tr, ref = recipe_trajectory
    rows = [bf16_steps.distances(mid[0], mid[1], z_g, jc, pc, key, draws)
            for (jc, pc, _, z_g, _, key, draws), (_, _, _, mid, _) in zip(tr.inputs, ref)]
    return _mean(rows)


def _quantities():
    return ["loss", *TERMS, "every_grad", BETA]


def _check(dist: dict, quantity: str, label: str) -> None:
    names = ([k for k in dist["jax"] if k.startswith(("style.", "renderer.")) and k != BETA]
             if quantity == "every_grad" else [quantity])
    for name in names:
        ours, ref = dist["port"][name], dist["jax"][name]
        print(f"{label} {name}: port {ours:.3e} JAX {ref:.3e}")
        assert ours <= BF16_RTOL * ref + BF16_ATOL, (label, name, ours, ref)


@pytest.mark.parametrize("quantity", _quantities())
def test_recipe_bf16_g_step_is_as_close_to_f32_as_jax_one_step(one_step, quantity):
    """At the recipe's first state, over ``DRAWS`` draws: the port's bf16
    step is no further from JAX's f32 step than JAX's bf16 step is
    (x 1.2 + 1e-4)."""
    _check(one_step, quantity, "one step")


@pytest.mark.parametrize("quantity", _quantities())
def test_recipe_bf16_g_step_is_as_close_to_f32_as_jax_over_20_steps(twenty_steps, quantity):
    """The same at each of the 20 states of JAX's f32 trajectory, each
    with its own step's inputs."""
    _check(twenty_steps, quantity, "20 steps")


def test_recipe_bf16_free_runs_print_beta_paths(bf16_steps, recipe_trajectory):
    """Both packages run the 20 D + G steps freely in bf16 from the same
    weights and inputs (JAX jitted); beta's paths are printed beside JAX's
    f32 path.  Each moves beta, and each bf16 run stays as near JAX's f32
    run as JAX's bf16 run does, within the chaotic recipe's spread: twice
    JAX's own f32 run under 1e-6 D-gradient noise (the bar of
    ``test_stage_a_trajectory_of_the_64_recipe_stays_within_jax_spread``),
    or JAX's bf16 run's own distance, whichever is larger."""
    tr, ref = recipe_trajectory
    jax_d16 = _jax_d_loss(tr.jcfg, tr.dcfg_j, tr.hp_j, jnp.bfloat16)
    jax_g16 = bf16_steps.jax16
    params, d_params = tr.params0, tr.d_params0
    g_tx, d_tx = j_optim.stage_a_optimizers()
    g_state, d_state = g_tx.init(params), d_tx.init(d_params)
    jax_path = []
    for jc, _, z_d, z_g, real, key, _ in tr.inputs:
        _, dg = jax_d16(d_params, params, jnp.asarray(z_d), jc, jnp.asarray(real))
        upd, d_state = d_tx.update(dg, d_state, d_params)
        d_params = optax.apply_updates(d_params, upd)
        (_, _), gg = jax_g16(params, d_params, jnp.asarray(z_g), jc, key)
        upd, g_state = g_tx.update(gg, g_state, params)
        params = optax.apply_updates(params, upd)
        jax_path.append(float(params["renderer"]["sigmoid_beta"][0]))

    g, d = _port_g(tr.params0, tr.pcfg), _port_d(tr.d_params0, tr.dcfg_p)
    g_opt, d_opt = optim.stage_a_optimizers(g, d)
    hp = bf16_steps.hp16
    port_path = []
    for jc, pc, z_d, z_g, real, key, draws in tr.inputs:
        d_loss, _ = steps.stage_a_d_loss(g, d, tr.pcfg, tr.dcfg_p, hp, _t(real),
                                         steps.StepInputs(_t(z_d), pc))
        steps._step(d_opt, d_loss)
        g_loss, _ = steps.stage_a_g_loss(g, d, tr.pcfg, tr.dcfg_p, hp,
                                         steps.StepInputs(_t(z_g), pc, eikonal_draws=draws))
        steps._step(g_opt, g_loss)
        port_path.append(g.renderer.sigmoid_beta.item())

    f32_path = [r[1] for r in ref]
    spread = [s[1] for s in tr.jax_run(d_grad_noise=1e-6)]
    print("beta, JAX f32:", np.round(f32_path, 7).tolist())
    print("beta, JAX bf16:", np.round(jax_path, 7).tolist())
    print("beta, port bf16:", np.round(port_path, 7).tolist())

    def far(path):
        return max(abs(a - b) / b for a, b in zip(path, f32_path))

    bar = max(2 * far(spread), far(jax_path))
    print(f"largest distance from JAX's f32 beta: port bf16 {far(port_path):.3e}, JAX bf16 "
          f"{far(jax_path):.3e}, JAX f32 under noise {far(spread):.3e}")
    for path in (jax_path, port_path):
        assert all(np.isfinite(path)) and abs(path[-1] - tr.params0["renderer"][
            "sigmoid_beta"][0]) > 1e-5
    assert far(port_path) <= BF16_RTOL * bar + BF16_ATOL


def test_film_sin_is_the_f32_sum_under_autograd_and_forward_mode():
    """``film_sin`` (the FiLM sine below f32, saving its bf16 inputs) gives
    the values, gradients, second derivatives and tangents of its plain
    composition ``fast_sin_lean(arg.float() + beta.float()).to(bf16)``."""
    rng = np.random.default_rng(3)
    arg0 = torch.from_numpy(rng.uniform(-40, 40, (2, 5, 8)).astype(np.float32)).bfloat16()
    beta0 = torch.from_numpy(rng.uniform(-1, 1, (2, 1, 8)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(np.float32))
    plain = lambda a, b: fast_sin_lean(a.float() + b.float()).to(a.dtype)  # noqa: E731
    outs = {}
    for name, fn in (("film_sin", film_sin), ("plain", plain)):
        arg, beta = arg0.clone().requires_grad_(), beta0.clone().requires_grad_()
        y = fn(arg, beta)
        ga, gb = torch.autograd.grad((y.float() * w).sum(), (arg, beta), create_graph=True)
        gga, ggb = torch.autograd.grad((ga.float() ** 2).sum() + (gb.float() ** 2).sum(),
                                       (arg, beta))
        with torch.autograd.forward_ad.dual_level():
            tangent = fn(torch.autograd.forward_ad.make_dual(arg0, torch.ones_like(arg0)),
                         torch.autograd.forward_ad.make_dual(beta0, 0.5 * torch.ones_like(beta0)))
            tangent = torch.autograd.forward_ad.unpack_dual(tangent).tangent
        outs[name] = (y, ga, gb, gga, ggb, tangent)
    assert outs["film_sin"][0].dtype == torch.bfloat16
    for ours, ref in zip(outs["film_sin"], outs["plain"]):
        assert ours.dtype == ref.dtype
        torch.testing.assert_close(ours.float(), ref.float(), rtol=0, atol=0)
