"""NGP training in the port against the JAX package, on the CPU.

The hash-grid encode's gradients (``ops/hash_encoder.py``: the table and
point gradients, the sorted table VJP, the double backward of the eikonal
term, the total variation), the smoothness loss, and the NGP stage-A G and
D losses with every gradient, against ``jax.grad`` / ``jax.value_and_grad``
of the JAX package's own functions.  Inputs are made with numpy from a seed
and given to both packages; the JAX draws (smoothness offset and jitter,
eikonal points) are taken from the JAX keys and fed to the port.

Two routes through the port's encode gradient are held here: the CPU
``hash_encode`` (the plain encode and its autograd) and the autograd
``Function`` that runs the kernels on the card, here over the kernels'
plain versions (``hash_encode_backward_reference``,
``hash_encode_double_backward_reference``).  Tolerances: f32 values and
gradients ``rtol 1e-5`` (``atol 1e-6`` of the largest entry: the scatter's
summation order differs); the stage-A losses as
``tests/test_torch_port_training.py``: values ``rtol 1e-4``, each gradient's
difference at most ``GRAD_RTOL`` of its norm plus ``GRAD_ATOL``; bf16 no
worse against the f32 truth than the JAX bf16 path (1.2x + a floor).
"""

from dataclasses import fields, replace
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdface_gan_tpu.config import load_config  # noqa: E402
from sdface_gan_tpu.config.build import (  # noqa: E402
    discriminator_configs,
    generator_config,
    train_hparams,
)
from sdface_gan_tpu.config.sdf_options import (  # noqa: E402
    get_vol_render_opt,
    rendering_overrides,
    resolve_renderer_type,
)
from sdface_gan_tpu.config.yaml_config import default_config_path  # noqa: E402
from sdface_gan_tpu.geometry import generate_camera_params as j_cams  # noqa: E402
from sdface_gan_tpu.losses import gan_losses as j_gan  # noqa: E402
from sdface_gan_tpu.losses import geometry_losses as j_geo  # noqa: E402
from sdface_gan_tpu.models import discriminator as j_disc  # noqa: E402
from sdface_gan_tpu.models import generator as j_gen  # noqa: E402
from sdface_gan_tpu.models import renderer as j_rend  # noqa: E402
from sdface_gan_tpu.ops import hash_encoder as jh  # noqa: E402
from sdface_gan_tpu.training import steps as j_steps  # noqa: E402
from sdface_gan_tpu_torch import configs  # noqa: E402
from sdface_gan_tpu_torch.geometry import CameraParams  # noqa: E402
from sdface_gan_tpu_torch.losses import geometry_losses  # noqa: E402
from sdface_gan_tpu_torch.models import discriminator, generator, renderer  # noqa: E402
from sdface_gan_tpu_torch.ops import _ext  # noqa: E402
from sdface_gan_tpu_torch.ops import hash_encoder as ph  # noqa: E402
from sdface_gan_tpu_torch.training import steps  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import (  # noqa: E402
    jax_disc_params_to_state_dict,
    jax_params_to_state_dict,
)
from test_torch_port_training import _two_threads  # noqa: E402,F401  (autouse: two threads)

GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-6
# JAX's CPU f32 sum of the smoothness's 357k squared differences drifts by
# ~3e-4 of the term (measured against an f64 sum of its own embeddings)
SMOOTH_VALUE_RTOL = 1e-3
CONFIGS = Path(__file__).resolve().parents[1] / "configs" / "256res"
GRIDS = {
    # log2 T = 7: every level past the first collides
    "tiny": dict(num_levels=3, level_dim=2, base_resolution=4, desired_resolution=32,
                 log2_hashmap_size=7),
    "wide": dict(num_levels=3, level_dim=4, base_resolution=4, desired_resolution=64,
                 log2_hashmap_size=8),
    "tuned_like": dict(num_levels=4, level_dim=8, base_resolution=16, desired_resolution=64,
                       log2_hashmap_size=10),
}
STYLE, RES, SAMPLES, BATCH = 16, 8, 4, 2
NGP = dict(type="ngp", style_dim=STYLE, width=STYLE, depth=2, ngp_num_levels=4,
           ngp_level_dim=2, ngp_finest_res=64, ngp_log2_hashmap_size=13)


def _t(x):
    return torch.from_numpy(np.array(x))


def _specs(name):
    return jh.HashGridSpec.create(**GRIDS[name]), ph.HashGridSpec.create(**GRIDS[name])


def _points(spec, n, bound, seed, kind="spread"):
    """``spread``: uniform points a little beyond the box (some outside),
    points on the cell faces of every level and points on the faces of the
    box.  The kinds that put many points on one table row, as the kernels'
    warp-level sums meet them: ``one_cell`` (every point in one cell of
    level 0), ``rays`` (24 sorted samples per ray, neighbouring rays next to
    each other, as the renderer orders them) and ``mixed`` (in-box,
    out-of-box, box-face points and one point repeated, shuffled)."""
    rng = np.random.default_rng(seed)
    if kind == "one_cell":
        pos = np.array([1.0, 2.0, 1.0]) + rng.uniform(0.1, 0.9, (n, 3))
        return ((pos - 0.5) / spec.level_scale(0) * 2.0 * bound - bound).astype(np.float32)
    if kind == "rays":
        i = np.arange(-(-n // 24))
        d = np.stack([(i % 4) / 4 - 0.5, (i // 4) / 4 - 0.5, np.full(len(i), 2.0)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = np.sort(rng.uniform(0.5, 2.3, (len(i), 24)), axis=-1)
        x = np.array([0.1, -0.2, -1.4 * bound]) + t[..., None] * bound * d[:, None]
        return x.reshape(-1, 3)[:n].astype(np.float32)
    if kind == "mixed":
        x = rng.uniform(-1.1 * bound, 1.1 * bound, (n, 3))
        kinds, axis = rng.integers(0, 4, n), rng.integers(0, 3, n)
        face = kinds == 1
        x[face, axis[face]] = np.where(rng.integers(0, 2, face.sum()) == 1, bound, -bound)
        x[kinds == 2] = np.array([0.11, -0.52, 0.93]) * bound
        return x.astype(np.float32)
    x = [rng.uniform(-1.15 * bound, 1.15 * bound, (n, 3))]
    for lvl in range(spec.num_levels):
        scale = spec.level_scale(lvl)
        m = rng.integers(1, int(scale) + 1, (6, 3))
        x.append((m - 0.5) / scale * 2.0 * bound - bound)
    faces = rng.uniform(-bound, bound, (12, 3))
    faces[np.arange(12), np.arange(12) % 3] = np.where(np.arange(12) % 2, bound, -bound)
    x.append(faces)
    return np.concatenate(x).astype(np.float32)


def _inputs(name, bound, seed=0, n=200, kind="spread"):
    j, p = _specs(name)
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((p.table_size, p.level_dim)).astype(np.float32)
    x = _points(p, n, bound, seed + 1, kind)
    g = rng.standard_normal((x.shape[0], p.output_dim)).astype(np.float32)
    return j, p, table, x, g


def _close(ours, ref, rtol=1e-5):
    ours = ours.detach().float().numpy()
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=1e-6 * max(np.abs(ref).max(), 1e-30))


def _encode_port(route, x, table, spec, bound):
    if route == "cpu_autograd":
        return ph.hash_encode(x, table, spec, bound=bound)
    # the Function that carries the kernels on the card, over their plain versions
    return ph._HashEncode.apply(ph._engine_view(x), ph._engine_view(table),
                                (spec, bound, tuple(range(spec.num_levels))))


ROUTES = ["cpu_autograd", "function"]


# ---------------------------------------------------------------------------
# The encode's gradients
# ---------------------------------------------------------------------------

# the points that put many points on one row (``_points``), each on every grid
DUPLICATE_KINDS = ("one_cell", "rays", "mixed")
ENCODE_GRAD_CASES = ([pytest.param(n, b, "spread", id=f"{n}-{b}") for n, b in
                      (("tiny", 1.0), ("tiny", 2.0), ("wide", 2.0), ("tuned_like", 1.0))]
                     + [pytest.param(n, 2.0, kind, id=f"{n}-2.0-{kind}")
                        for n in ("tiny", "wide", "tuned_like") for kind in DUPLICATE_KINDS])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name,bound,kind", ENCODE_GRAD_CASES)
def test_encode_table_and_point_grads_match_jax(route, name, bound, kind):
    """d table and d x of ``<g, encode>`` against ``jax.grad``: collisions,
    out-of-box points (zero), cell faces and box faces (half the derivative,
    as ``jnp.clip``'s); the table gradient also against JAX's explicit
    ``hash_encode_vjp_sorted``.  The duplicate-heavy kinds hold the plain
    versions (the port's CPU path) where the kernels sum lanes of one row."""
    j, p, table, x, g = _inputs(name, bound, kind=kind)

    def jloss(xx, tt):
        return jnp.sum(jh.hash_encode(xx, tt, j, bound=bound) * g)

    jdx, jdt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(table))
    xt, tt = _t(x).requires_grad_(), _t(table).requires_grad_()
    out = _encode_port(route, xt, tt, p, bound)
    dx, dt = torch.autograd.grad(out, (xt, tt), _t(g))
    oob = np.any(np.abs(x) > bound, -1)
    on_face = np.any(np.abs(x) == bound, -1) & ~oob
    assert (oob.any() and on_face.any()) or kind in ("one_cell", "rays")
    np.testing.assert_array_equal(dx.numpy()[oob], 0.0)
    _close(dx, jdx)
    _close(dt, jdt)
    want_dx, want_dt = ph.hash_encode_backward_reference(_t(x), _t(table), _t(g), p, bound)
    _close(want_dx, jdx)
    _close(want_dt, jdt)
    _close(want_dt, jh.hash_encode_vjp_sorted(jnp.asarray(x), jnp.asarray(table), j,
                                              jnp.asarray(g), bound=bound))


@pytest.mark.parametrize("route", ROUTES)
def test_encode_grads_only_where_asked(route):
    """A point gradient alone (the eikonal's first pass) and a table
    gradient alone; the table's leaf keeps no ``.grad`` it was not asked for."""
    _, p, table, x, g = _inputs("tiny", 2.0, seed=3)
    xt, tt = _t(x).requires_grad_(), _t(table).requires_grad_()
    (dx,) = torch.autograd.grad(_encode_port(route, xt, tt, p, 2.0), xt, _t(g))
    (dt,) = torch.autograd.grad(_encode_port(route, xt, tt, p, 2.0), tt, _t(g))
    want_dx, want_dt = ph.hash_encode_backward_reference(_t(x), _t(table), _t(g), p, 2.0)
    _close(dx, want_dx.numpy())
    _close(dt, want_dt.numpy())
    assert xt.grad is None and tt.grad is None


def test_function_asks_the_kernels_only_for_needed_grads(monkeypatch):
    """``needs_input_grad`` is fixed at the forward; the ``Function`` also
    asks the engine which inputs the running pass needs.  The eikonal's
    first pass (``autograd.grad(out, x, create_graph=True)``) asks K1 for
    d x alone; the table's pass asks K2 for d table alone (the cotangent's
    leaf is not an input) and K1 for d table alone (nor is x's)."""
    calls = []
    k1, k2 = ph.hash_encode_backward, ph.hash_encode_double_backward
    monkeypatch.setattr(ph, "hash_encode_backward", lambda *a, **k: calls.append(
        ("K1", k["need_x"], k["need_table"])) or k1(*a, **k))
    monkeypatch.setattr(ph, "hash_encode_double_backward", lambda *a, **k: calls.append(
        ("K2", k["need_table"], k["need_g"])) or k2(*a, **k))
    _, p, table, x, a = _inputs("tiny", 2.0, seed=4, n=60)
    xt, tt, at = (_t(v).requires_grad_() for v in (x, table, a))
    out = _encode_port("function", xt, tt, p, 2.0)
    (dx,) = torch.autograd.grad(torch.sum(out * at), xt, create_graph=True)
    assert calls == [("K1", True, False)]
    (dt,) = torch.autograd.grad(torch.sum(out * at) + torch.sum(dx ** 2), tt)
    assert sorted(calls[1:]) == [("K1", False, True), ("K2", True, False)]
    assert dt.shape == tt.shape and xt.grad is None and at.grad is None


def test_engine_query_is_available(monkeypatch):
    """The private engine query behind the test above exists in this
    PyTorch.  Without it the ``Function`` falls back to every gradient that
    ``needs_input_grad`` names: the eikonal's first pass then also asks K1
    for the table's, and the gradients stay right."""
    assert callable(ph._WILL_ENGINE_EXECUTE)
    monkeypatch.setattr(ph, "_WILL_ENGINE_EXECUTE", None)
    calls = []
    k1 = ph.hash_encode_backward
    monkeypatch.setattr(ph, "hash_encode_backward", lambda *a, **k: calls.append(
        ("K1", k["need_x"], k["need_table"])) or k1(*a, **k))
    _, p, table, x, a = _inputs("tiny", 2.0, seed=4, n=60)
    xt, tt = _t(x).requires_grad_(), _t(table).requires_grad_()
    (dx,) = torch.autograd.grad(torch.sum(_encode_port("function", xt, tt, p, 2.0) * _t(a)),
                                xt, create_graph=True)
    assert calls == [("K1", True, True)]
    want_dx, _ = ph.hash_encode_backward_reference(_t(x), _t(table), _t(a), p, 2.0)
    _close(dx, want_dx.numpy())


@pytest.mark.parametrize("route", ROUTES)
def test_encode_bf16_table_grads_hold_the_bf16_contract(route):
    """A bf16 table with a bf16 cotangent: the gradients' error against the
    f32 truth is no worse than the JAX bf16 path's (1.2x + a floor)."""
    j, p, table, x, g = _inputs("wide", 2.0, seed=5)
    t16 = table.astype(jnp.bfloat16).astype(np.float32)
    g16 = g.astype(jnp.bfloat16).astype(np.float32)

    def grads(tab, cot, dtype):
        def loss(xx, tt):
            out = jh.hash_encode(xx, tt.astype(dtype), j, bound=2.0).astype(jnp.float32)
            return jnp.sum(out * cot)
        return jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(tab))

    tdx, tdt = grads(t16, g16, jnp.float32)  # the truth on the same rounded inputs
    jdx, jdt = grads(t16, g16, jnp.bfloat16)
    xt = _t(x).requires_grad_()
    tt = _t(t16).to(torch.bfloat16).requires_grad_()
    out = _encode_port(route, xt, tt, p, 2.0)
    assert out.dtype == torch.bfloat16
    dx, dt = torch.autograd.grad(out, (xt, tt), _t(g16).to(torch.bfloat16))
    assert dt.dtype == torch.bfloat16 and dx.dtype == torch.float32
    for ours, jax_bf16, truth in ((dx, jdx, tdx), (dt, jdt, tdt)):
        truth = np.asarray(truth, np.float32)
        err_ours = np.abs(ours.float().numpy() - truth).mean()
        err_jax = np.abs(np.asarray(jax_bf16, np.float32) - truth).mean()
        assert err_ours <= 1.2 * err_jax + 1e-6 * np.abs(truth).mean(), (err_ours, err_jax)


@pytest.mark.parametrize("name,bound", [("tiny", 2.0), ("wide", 1.0)])
def test_vjp_sorted_matches_jax(name, bound):
    j, p, table, x, g = _inputs(name, bound, seed=7)
    ref = jh.hash_encode_vjp_sorted(jnp.asarray(x), jnp.asarray(table), j, jnp.asarray(g),
                                    bound=bound)
    ours = ph.hash_encode_vjp_sorted(_t(x), _t(table), p, _t(g), bound=bound)
    assert ours.shape == tuple(ref.shape) and ours.dtype == torch.float32
    _close(ours, ref)
    # deterministic: the same bits twice
    assert torch.equal(ours, ph.hash_encode_vjp_sorted(_t(x), _t(table), p, _t(g), bound))


SECOND_ORDER = ["eikonal_table", "eikonal_cotangent", "table_grad_cotangent"]
SECOND_ORDER_CASES = [pytest.param(case, kind, id=case if kind == "spread" else f"{case}-{kind}")
                      for case in SECOND_ORDER for kind in ("spread",) + DUPLICATE_KINDS]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("case,kind", SECOND_ORDER_CASES)
def test_second_order_grads_match_jax(route, case, kind):
    """Second-order losses through the encode against ``jax.grad``:
    ``sum ||d <enc, a> / d x||^2`` with respect to the table (the eikonal
    term's table gradient) and to ``a``, and ``sum (d <enc, a> / d table)^2``
    with respect to ``a`` (an encode of the cotangent); on the spread points
    and on the duplicate-heavy kinds of ``_points``."""
    j, p, table, x, a = _inputs("tiny", 2.0, seed=9, n=120, kind=kind)

    def inner(xx, tt, aa):
        return jnp.sum(jh.hash_encode(xx, tt, j, bound=2.0) * aa)

    if case == "eikonal_table":
        jref = jax.grad(lambda tt: jnp.sum(jax.grad(inner)(jnp.asarray(x), tt,
                                                           jnp.asarray(a)) ** 2))(
            jnp.asarray(table))
    elif case == "eikonal_cotangent":
        jref = jax.grad(lambda aa: jnp.sum(jax.grad(inner)(jnp.asarray(x), jnp.asarray(table),
                                                           aa) ** 2))(jnp.asarray(a))
    else:
        jref = jax.grad(lambda aa: jnp.sum(jax.grad(inner, argnums=1)(
            jnp.asarray(x), jnp.asarray(table), aa) ** 2))(jnp.asarray(a))
    xt = _t(x).requires_grad_()
    tt = _t(table).requires_grad_()
    at = _t(a).requires_grad_()
    out = _encode_port(route, xt, tt, p, 2.0)
    wrt = tt if case == "eikonal_table" else at
    first = xt if case != "table_grad_cotangent" else tt
    (d1,) = torch.autograd.grad(torch.sum(out * at), first, create_graph=True)
    (ours,) = torch.autograd.grad(torch.sum(d1 ** 2), wrt)
    _close(ours, jref)


def test_hash_table_total_variation_matches_jax():
    j, p, table, x, _ = _inputs("tiny", 2.0, seed=11)
    jv, jg = jax.value_and_grad(lambda t: jh.hash_table_total_variation(
        t, j, jnp.asarray(x), bound=2.0))(jnp.asarray(table))
    tt = _t(table).requires_grad_()
    value = ph.hash_table_total_variation(tt, p, _t(x), bound=2.0)
    (grad,) = torch.autograd.grad(value, tt)
    np.testing.assert_allclose(value.item(), float(jv), rtol=1e-5)
    _close(grad, jg)


def _jax_smooth_draws(key):
    """The two uniform draws ``hash_smoothness_loss`` makes from its key."""
    k_off, k_jit = jax.random.split(key)
    return (_t(jax.random.uniform(k_off, (3,))),
            _t(jax.random.uniform(k_jit, (1, 1, 1, 3))).reshape(3))


@pytest.mark.parametrize("route", ["cpu", "function"])
def test_hash_smoothness_loss_matches_jax_on_its_draws(route, monkeypatch):
    """JAX's own draws from its key, fed to the port: value and table
    gradient (the grid of 31^3 points inside the stage-A box, bound 2).
    The value within ``SMOOTH_VALUE_RTOL`` of JAX's, whose CPU f32 sum of the
    357k squared differences is off by ~3e-4 of itself (an f64 sum of JAX's
    own embeddings gives the port's value); the port's f32 value within 1e-6
    of its own f64 evaluation."""
    j, p, table, _, _ = _inputs("wide", 2.0, seed=13)
    key = jax.random.PRNGKey(4)
    jv, jg = jax.value_and_grad(lambda t: j_geo.hash_smoothness_loss(
        t, j, key, j_steps.SMOOTH_BBOX, bound=2.0))(jnp.asarray(table))
    if route == "function":
        monkeypatch.setattr(geometry_losses, "hash_encode", lambda x, t, s, bound: _encode_port(
            "function", x, t, s, bound))
    tt = _t(table).requires_grad_()
    value = geometry_losses.hash_smoothness_loss(tt, p, steps.SMOOTH_BBOX, bound=2.0,
                                                 draws=_jax_smooth_draws(key))
    (grad,) = torch.autograd.grad(value, tt)
    np.testing.assert_allclose(value.item(), float(jv), rtol=SMOOTH_VALUE_RTOL)
    value64 = geometry_losses.hash_smoothness_loss(tt.detach().double(), p, steps.SMOOTH_BBOX,
                                                   bound=2.0, draws=_jax_smooth_draws(key))
    np.testing.assert_allclose(value.item(), value64.item(), rtol=1e-6)
    _close(grad, jg)
    with pytest.raises(ValueError, match="generator or draws"):
        geometry_losses.hash_smoothness_loss(tt, p, steps.SMOOTH_BBOX)


# ---------------------------------------------------------------------------
# NGP stage A: G and D losses with every gradient
# ---------------------------------------------------------------------------

def _configs_a(**rkw):
    rkw = dict(out_im_res=RES, n_samples=SAMPLES, output_features=False, return_sdf=True,
               **NGP, **rkw)
    return (j_gen.GeneratorConfig(size=16, style_dim=STYLE, full_pipeline=False,
                                  renderer=j_rend.RendererConfig(**rkw)),
            generator.GeneratorConfig(size=16, style_dim=STYLE, full_pipeline=False,
                                      renderer=renderer.RendererConfig(**rkw)))


@pytest.fixture(scope="module")
def ngp_a():
    jcfg, pcfg = _configs_a()
    params = j_gen.init_generator(jax.random.PRNGKey(0), jcfg)
    net = params["renderer"]["network"]
    # std 0.3 (the init's 1e-4 would hide the encode from every loss term)
    net["hash_table"] = jnp.asarray(0.3 * np.random.default_rng(9).standard_normal(
        net["hash_table"].shape).astype(np.float32))
    dcfg_j = j_disc.VolumeRenderDiscConfig(in_res=RES)
    d_params = j_disc.init_volume_render_discriminator(jax.random.PRNGKey(5), dcfg_j)
    return dict(params=params, d_params=d_params, dcfg_j=dcfg_j,
                dcfg_p=discriminator.VolumeRenderDiscConfig(in_res=RES))


def _port_g(params, pcfg):
    g = generator.Generator(pcfg, device="cpu")
    g.load_state_dict(jax_params_to_state_dict(params, pcfg))
    return g


def _port_d(params, dcfg):
    d = discriminator.VolumeRenderDiscriminator(dcfg)
    d.load_state_dict(jax_disc_params_to_state_dict(params))
    return d


def _cams(seed=1):
    jc = j_cams(RES, jax.random.PRNGKey(seed), batch=BATCH)
    return jc, CameraParams(*[_t(c) for c in jc])


def _z(seed):
    return np.random.default_rng(seed).standard_normal((BATCH, STYLE)).astype(np.float32)


def _jax_ngp_g_loss(jcfg, dcfg, hp, d_params, z, jc, key, skey, cast_dt=None):
    """The NGP stage-A G loss of ``make_stage_a_g_step`` with fixed inputs:
    the smoothness on the uncast table, as the step feeds it."""
    def loss_fn(gp):
        out = j_gen.generator_forward(j_steps._cast_params(gp, cast_dt), jcfg, [z],
                                      jc.extrinsics, jc.focal, jc.near, jc.far, key=key,
                                      return_sdf=True, return_xyz=True, return_eikonal=True)
        fake_pred, fake_view = j_disc.apply_volume_render_discriminator(d_params, dcfg,
                                                                        out.thumb_rgb)
        eik, msurf = j_geo.eikonal_loss(out.eikonal_term, out.sdf, beta=hp.min_surf_beta)
        smooth = j_geo.hash_smoothness_loss(gp["renderer"]["network"]["hash_table"],
                                            jcfg.renderer.network_config().grid, skey,
                                            j_steps.SMOOTH_BBOX, bound=2.0)
        loss = (j_gan.g_nonsaturating_loss(fake_pred)
                + hp.view_lambda * j_gan.viewpoints_loss(fake_view, jc.viewpoint)
                + hp.eikonal_lambda * eik + hp.min_surf_lambda * msurf
                + hp.smooth_lambda * smooth)
        return loss, (hp.eikonal_lambda * eik, hp.smooth_lambda * smooth)
    return loss_fn


VARIANTS = {"full_remat": dict(remat=True), "full_no_remat": dict(remat=False),
            "subsampled": dict(remat=False, eikonal_subsample=32, perturb=0.0)}


def _g_case(ngp_a, variant, z_seed):
    jcfg, pcfg = _configs_a(**VARIANTS[variant])
    jc, pc = _cams()
    z = _z(z_seed)
    key = draws = None
    if variant == "subsampled":
        # render key -> (depth, noise, eikonal) -> (uv, t), as the JAX render draws
        key = jax.random.PRNGKey(12)
        kuv, kt = jax.random.split(jax.random.split(jax.random.split(key)[0], 3)[2])
        draws = (_t(jax.random.uniform(kuv, (BATCH, 32, 2))),
                 _t(jax.random.uniform(kt, (BATCH, 32))))
    skey = jax.random.PRNGKey(13)
    inputs = steps.StepInputs(_t(z), pc, eikonal_draws=draws,
                              smooth_draws=_jax_smooth_draws(skey))
    return jcfg, pcfg, jc, z, key, skey, inputs


def _assert_grads(module, grads, ref_sd):
    names = [n for n, _ in module.named_parameters()]
    assert len(names) == len(grads) and "renderer.network.encoder.embeddings" in names
    for name, g in zip(names, grads):
        r = ref_sd[name]
        g = torch.zeros_like(r) if g is None else g
        err, scale = (g - r).norm().item(), r.norm().item()
        assert err <= GRAD_RTOL * scale + GRAD_ATOL, (name, err, scale)


def _function_encode(x, table, spec, bound=1.0, levels=None):
    """The card's encode dispatch on the CPU: the autograd ``Function``
    (over the kernels' plain versions) whenever autograd records."""
    levels = ph._levels(spec, levels)
    if torch.is_grad_enabled() and (x.requires_grad or table.requires_grad):
        return ph._HashEncode.apply(ph._engine_view(x), ph._engine_view(table),
                                    (spec, float(bound), levels))
    return ph._encode(x, table, spec, bound, levels)


@pytest.mark.parametrize("variant,route", [(v, "cpu_autograd") for v in VARIANTS]
                         + [("full_remat", "function"), ("subsampled", "function")])
def test_ngp_stage_a_g_loss_and_every_grad_match_jax(ngp_a, variant, route, monkeypatch):
    """Nonsaturating, viewpoint, eikonal (through the encode's double
    backward), minimal surface and hash smoothness, and the gradient of
    every G parameter, the hash table's included, against ``jax.grad``;
    through the CPU's autograd and through the card's ``Function`` (inside
    the remat checkpoint too)."""
    if route == "function":
        from sdface_gan_tpu_torch.models import siren

        for module in (siren, geometry_losses):
            monkeypatch.setattr(module, "hash_encode", _function_encode)
    jcfg, pcfg, jc, z, key, skey, inputs = _g_case(ngp_a, variant, z_seed=11)
    hp = j_steps.TrainHParams(batch=BATCH, style_dim=STYLE)
    (jl, (jeik, jsmooth)), jgrads = jax.value_and_grad(
        _jax_ngp_g_loss(jcfg, ngp_a["dcfg_j"], hp, ngp_a["d_params"], jnp.asarray(z), jc,
                        key, skey), has_aux=True)(ngp_a["params"])
    g = _port_g(ngp_a["params"], pcfg)
    d = _port_d(ngp_a["d_params"], ngp_a["dcfg_p"])
    loss, m = steps.stage_a_g_loss(g, d, pcfg, ngp_a["dcfg_p"],
                                   steps.TrainHParams(batch=BATCH, style_dim=STYLE), inputs)
    np.testing.assert_allclose(m["g_eikonal"].item(), float(jeik), rtol=1e-4)
    np.testing.assert_allclose(m["g_smooth"].item(), float(jsmooth), rtol=SMOOTH_VALUE_RTOL)
    np.testing.assert_allclose((loss - m["g_smooth"]).item(), float(jl - jsmooth), rtol=1e-4)
    assert float(jeik) > 0 and float(jsmooth) > 0
    grads = torch.autograd.grad(loss, list(g.parameters()), allow_unused=True)
    _assert_grads(g, grads, jax_params_to_state_dict(jgrads, pcfg))


def test_ngp_stage_a_g_loss_bf16_params_hold_the_bf16_contract(ngp_a):
    """``g_param_dtype="bfloat16"`` (the tuned yaml's): the G forward on
    bf16 parameters, the smoothness on the f32 master table; the gradients
    come back f32 and their error against the f32 truth is no worse than
    the JAX bf16 step's (1.2x + 1e-3 of the gradients' norm)."""
    jcfg, pcfg, jc, z, key, skey, inputs = _g_case(ngp_a, "subsampled", z_seed=17)
    hp = j_steps.TrainHParams(batch=BATCH, style_dim=STYLE)

    def jax_grads(cast):
        fn = _jax_ngp_g_loss(jcfg, ngp_a["dcfg_j"], hp, ngp_a["d_params"], jnp.asarray(z), jc,
                             key, skey, cast_dt=cast)
        return jax_params_to_state_dict(jax.grad(lambda p: fn(p)[0])(ngp_a["params"]), pcfg)

    truth, jax16 = jax_grads(None), jax_grads(jnp.bfloat16)
    g = _port_g(ngp_a["params"], pcfg)
    d = _port_d(ngp_a["d_params"], ngp_a["dcfg_p"])
    loss, m = steps.stage_a_g_loss(g, d, pcfg, ngp_a["dcfg_p"], steps.TrainHParams(
        batch=BATCH, style_dim=STYLE, g_param_dtype="bfloat16"), inputs)
    assert all(bool(torch.isfinite(v)) for v in m.values())
    names = [n for n, _ in g.named_parameters()]
    ours = dict(zip(names, torch.autograd.grad(loss, list(g.parameters()), allow_unused=True)))
    assert all(t is None or t.dtype == torch.float32 for t in ours.values())

    def err(grads):
        num = sum((torch.zeros_like(truth[n]) if grads[n] is None else grads[n]
                   - truth[n]).norm() ** 2 for n in names) ** 0.5
        return float(num)

    norm = float(sum(truth[n].norm() ** 2 for n in names) ** 0.5)
    e_ours, e_jax = err(ours), err({n: _t(np.asarray(jax16[n])) for n in names})
    assert 0 < e_ours <= 1.2 * e_jax + 1e-3 * norm, (e_ours, e_jax, norm)


@pytest.mark.parametrize("with_r1", [True, False])
def test_ngp_stage_a_d_loss_and_grads_match_jax(ngp_a, with_r1):
    jcfg, pcfg = _configs_a()
    params, d_params = ngp_a["params"], ngp_a["d_params"]
    dcfg_j, dcfg_p = ngp_a["dcfg_j"], ngp_a["dcfg_p"]
    hp = j_steps.TrainHParams(batch=BATCH, style_dim=STYLE, a_d_reg_every=1 if with_r1 else 4)
    jc, pc = _cams()
    z = _z(14)
    real = np.random.default_rng(15).uniform(-1, 1, (BATCH, RES, RES, 3)).astype(np.float32)
    fake = j_gen.generator_forward(params, jcfg, [jnp.asarray(z)], jc.extrinsics, jc.focal,
                                   jc.near, jc.far).thumb_rgb

    def jloss(dp):
        fake_pred, fake_view = j_disc.apply_volume_render_discriminator(dp, dcfg_j, fake)
        d_view = hp.view_lambda * j_gan.viewpoints_loss(fake_view, jc.viewpoint)
        if with_r1:
            real_pred, pen = j_gan.d_logits_and_r1(
                lambda img: j_disc.apply_volume_render_discriminator(dp, dcfg_j, img)[0],
                jnp.asarray(real))
            r1 = hp.r1 * 0.5 * pen * hp.a_d_reg_every
        else:
            real_pred, r1 = j_disc.apply_volume_render_discriminator(dp, dcfg_j,
                                                                     jnp.asarray(real))[0], 0.0
        return j_gan.d_logistic_loss(real_pred, fake_pred) + r1 + d_view

    jl, jg = jax.value_and_grad(jloss)(d_params)
    g, d = _port_g(params, pcfg), _port_d(d_params, dcfg_p)
    loss, m = steps.stage_a_d_loss(
        g, d, pcfg, dcfg_p, steps.TrainHParams(batch=BATCH, style_dim=STYLE,
                                               a_d_reg_every=hp.a_d_reg_every),
        _t(real), steps.StepInputs(_t(z), pc), with_r1=with_r1)
    assert ("r1" in m) == with_r1
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    grads = torch.autograd.grad(loss, list(d.parameters()), allow_unused=True)
    ref = jax_disc_params_to_state_dict(jg)
    for (name, _), gr in zip(d.named_parameters(), grads):
        r = ref[name]
        gr = torch.zeros_like(r) if gr is None else gr
        assert (gr - r).norm().item() <= GRAD_RTOL * r.norm().item() + GRAD_ATOL, name


def test_ngp_stage_a_g_loss_needs_smoothness_draws(ngp_a):
    """Deterministic inputs without ``smooth_draws`` raise; with a generator
    the draws come from it, and the NGP step runs no plain-path guard."""
    _, pcfg = _configs_a()
    g = _port_g(ngp_a["params"], pcfg)
    d = _port_d(ngp_a["d_params"], ngp_a["dcfg_p"])
    _, pc = _cams()
    hp = steps.TrainHParams(batch=BATCH, style_dim=STYLE)
    with pytest.raises(ValueError, match="generator or draws"):
        steps.stage_a_g_loss(g, d, pcfg, ngp_a["dcfg_p"], hp, steps.StepInputs(_t(_z(3)), pc))
    gen = torch.Generator().manual_seed(0)
    before = dict(_ext.LAUNCHES)
    loss, m = steps.stage_a_g_loss(g, d, pcfg, ngp_a["dcfg_p"], hp,
                                   steps.StepInputs(_t(_z(3)), pc, generator=gen))
    assert np.isfinite(loss.item()) and m["g_smooth"].item() > 0
    assert _ext.LAUNCHES == before  # CPU tensors: plain versions only


# ---------------------------------------------------------------------------
# Configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,ngp_flag,tpu", [("ffhq_256_sdf_ngp_tpu", False, True),
                                               ("ffhq_256_sdf_ngp", True, False)])
def test_stage_a_ngp_configs_match_the_yaml(name, ngp_flag, tpu):
    """Stage A of both NGP files resolved as ``train.py`` resolves them (the
    upstream file by ``--ngp 1``, the tuned one by its ``rendering.type``):
    generator, discriminator and training hyperparameters."""
    cfg = load_config(str(CONFIGS / f"{name}.yaml"), default_config_path())
    opt = get_vol_render_opt(cfg["training"]["out_dir"].split("/")[1], True,
                             ngp=resolve_renderer_type(cfg, ngp_flag),
                             size=cfg["data"].get("img_size", 256),
                             extra_argv=rendering_overrides(cfg))
    ref, ours = generator_config(opt, stage_a=True), getattr(configs, name)(stage_a=True)
    for f in fields(ours):
        if f.name != "renderer":
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    for f in fields(ours.renderer):
        assert getattr(ours.renderer, f.name) == getattr(ref.renderer, f.name), f.name
    assert ours.renderer.type == "ngp" and not ours.renderer.output_features
    assert ours.renderer.network_config().grid.offsets == ref.renderer.network_config().grid.offsets
    hp_ref, hp = train_hparams(opt), configs.train_hparams(tpu=tpu, ngp=True)
    for f in fields(hp):
        if f.name != "camera":
            assert getattr(hp, f.name) == getattr(hp_ref, f.name), f.name
    assert hp.g_param_dtype == ("bfloat16" if tpu else "float32") and hp.smooth_lambda == 1000.0
    for o, r in zip(configs.discriminator_configs(), discriminator_configs(opt)):
        assert vars(o) == vars(r)


def test_training_ngp_field_runs_no_packed_table():
    """Training never packs: the stage-A NGP renderer's encode goes through
    ``hash_encode`` (the differentiable encode), not the packed gather."""
    _, pcfg = _configs_a(ngp_pack_mb=1)
    g = generator.Generator(pcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    assert g.renderer.network.encoder.packed is None
    _, pc = _cams()
    out = renderer.render(g.renderer, replace(pcfg.renderer, perturb=0.0), pc.focal,
                          pc.extrinsics, pc.near, pc.far, _t(_z(2)), return_eikonal=True)
    loss = out.rgb.sum() + out.eikonal_term.square().sum()
    (grad,) = torch.autograd.grad(loss, g.renderer.network.encoder.embeddings)
    assert bool(torch.isfinite(grad).all()) and grad.abs().sum() > 0
