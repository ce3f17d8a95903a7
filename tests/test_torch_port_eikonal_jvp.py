"""The forward-mode eikonal term (``eikonal_mode="jvp"``) against JAX, on the CPU.

The JAX renderer's ``jax.linearize`` over the field and three unit tangents
(``sdface_gan_tpu/models/renderer.py``) against the port's three
forward-mode passes, for the SIREN, FC and NGP fields with remat on and
off: the eikonal term, and the parameter
gradients of the eikonal loss (reverse over forward), at the JAX test's
own bars (``tests/test_models.py``'s ``test_eikonal_jvp_matches_vjp``: the
term ``rtol 1e-4 / atol 1e-5``, the gradients ``rtol 5e-4 / atol 1e-5``),
and against the port's reverse mode at the same bars.  The stage-A G loss
and every G gradient in jvp mode against JAX's; the NGP field also through
the autograd ``Function`` that runs the hash-grid kernels on the card,
here over their plain versions.  JAX's bars are taken as
``test_render_eikonal_matches_jax_vjp`` takes them: the atol scaled by the
largest entry of the JAX value.  The FC field's own forward stands further
from JAX's than that in either mode (its positional encoding's sines of
arguments up to 2^9 pi / 2 times the point, whose f32 rounding XLA and
PyTorch do not share): there the atol is a fixed 5e-4 of the largest
entry for the term (measured: 2.0e-4 in either mode) and 1e-4 for the
gradients (measured: 4.2e-5), and the port's reverse mode is held against
JAX's at the same bars, so that the shared cause has its own reading.
Then the two ``Function``\\ s on the field path that carry a ``jvp``: the
sine's and the encode's, against forward AD through their plain versions,
and the encode's with a bf16 table against JAX's ``jax.jvp`` at bf16.
Weights come from the JAX initializers and cross by
``jax_params_to_state_dict``; inputs are made with numpy from a seed.
"""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.autograd.forward_ad as fwAD  # noqa: E402

from sdface_gan_tpu.models import generator as j_gen  # noqa: E402
from sdface_gan_tpu.models import renderer as j_rend  # noqa: E402
from sdface_gan_tpu.ops import hash_encoder as jh  # noqa: E402
from sdface_gan_tpu.training import steps as j_steps  # noqa: E402
from sdface_gan_tpu_torch.models import generator, renderer, siren  # noqa: E402
from sdface_gan_tpu_torch.ops import hash_encoder as ph  # noqa: E402
from sdface_gan_tpu_torch.ops.transcendental import fast_sin, fast_sin_lean  # noqa: E402
from sdface_gan_tpu_torch.training import steps  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import jax_params_to_state_dict  # noqa: E402
from test_torch_port_ngp_training import (  # noqa: E402
    _function_encode,
    _g_case,
    _jax_ngp_g_loss,
    _inputs,
    ngp_a,  # noqa: F401  (fixture)
)
from test_torch_port_ngp_training import _assert_grads as _assert_ngp_grads  # noqa: E402
from test_torch_port_ngp_training import _port_d as _ngp_port_d  # noqa: E402
from test_torch_port_ngp_training import _port_g as _ngp_port_g  # noqa: E402
from test_torch_port_training import (  # noqa: E402
    BATCH,
    STYLE,
    _assert_grads,
    _cams,
    _configs_a,
    _grads,
    _jax_stage_a_g_loss,
    _port_d,
    _port_g,
    _t,
    _two_threads,  # noqa: F401  (autouse: two threads)
    _z,
    stage_a,  # noqa: F401  (fixture)
)

EIK_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
# the FC field's bars (see the module's docstring): 2.5x its measured gaps
FC_EIK_TOL = dict(rtol=1e-4, atol=5e-4)
FC_GRAD_TOL = dict(rtol=5e-4, atol=1e-4)
FIELDS = {
    "sdf": dict(type="sdf", width=16, depth=2),
    "fc": dict(type="fc", width=16, depth=3),
    "ngp": dict(type="ngp", width=STYLE, depth=2, ngp_num_levels=4, ngp_level_dim=2,
                ngp_finest_res=32, ngp_log2_hashmap_size=8),
}
# (field, remat, route): every field both ways through three forward-mode
# passes; the NGP field also through the card's encode Function
RENDER_CASES = ([(f, remat, "passes") for f in FIELDS for remat in (True, False)]
                + [("ngp", True, "function"), ("ngp", False, "function")])


def _field_configs(field, **kw):
    rkw = dict(out_im_res=4, n_samples=3, style_dim=STYLE, perturb=0.0, **FIELDS[field], **kw)
    return (j_gen.GeneratorConfig(size=16, style_dim=STYLE, full_pipeline=False,
                                  renderer=j_rend.RendererConfig(**rkw)),
            generator.GeneratorConfig(size=16, style_dim=STYLE, full_pipeline=False,
                                      renderer=renderer.RendererConfig(**rkw)))


def _eik_loss(term):
    return (term.norm(dim=-1) - 1.0).pow(2).mean()


@pytest.fixture(scope="module")
def fields_jax():
    """Per field: the JAX parameters, the cameras and style, and JAX's jvp
    eikonal term and the gradient of the eikonal loss (jitted)."""
    out = {}
    jc = _cams(seed=1)[0]
    style = np.random.default_rng(3).standard_normal((BATCH, STYLE)).astype(np.float32)
    for field in FIELDS:
        jcfg, _ = _field_configs(field, eikonal_mode="jvp")
        params = j_gen.init_generator(jax.random.PRNGKey(0), jcfg)
        if field == "ngp":
            # std 0.3 (the init's 1e-4 would hide the encode from the term)
            net = params["renderer"]["network"]
            net["hash_table"] = jnp.asarray(0.3 * np.random.default_rng(9).standard_normal(
                net["hash_table"].shape).astype(np.float32))

        def term(rp, rcfg=jcfg.renderer):
            return j_rend.render(rp, rcfg, jc.focal, jc.extrinsics, jc.near, jc.far,
                                 jnp.asarray(style), return_eikonal=True).eikonal_term

        def loss(rp, rcfg=jcfg.renderer):
            return jnp.mean((jnp.linalg.norm(term(rp, rcfg), axis=-1) - 1.0) ** 2)

        vjp_cfg = replace(jcfg.renderer, eikonal_mode="vjp")
        out[field] = dict(
            params=params, style=style,
            term=np.asarray(jax.jit(term)(params["renderer"])),
            grads=jax.jit(jax.grad(loss))(params["renderer"]),
            vjp_term=np.asarray(jax.jit(lambda rp: term(rp, vjp_cfg))(params["renderer"])),
            vjp_grads=jax.jit(jax.grad(lambda rp: loss(rp, vjp_cfg)))(params["renderer"]))
    return out


def _port_render(field, fj, remat, route, mode, monkeypatch):
    _, pcfg = _field_configs(field, remat=remat, eikonal_mode=mode)
    g = _port_g(fj["params"], pcfg)
    if route == "function":
        monkeypatch.setattr(siren, "hash_encode", _function_encode)
    _, pc = _cams(seed=1)
    out = renderer.render(g.renderer, pcfg.renderer, pc.focal, pc.extrinsics, pc.near, pc.far,
                          _t(fj["style"]), return_eikonal=True)
    params = list(g.renderer.parameters())
    grads = torch.autograd.grad(_eik_loss(out.eikonal_term), params, allow_unused=True)
    return g, pcfg, out, [torch.zeros_like(p) if d is None else d for p, d in zip(params, grads)]


def _jax_grads(g, pcfg, params, jgrads):
    """JAX's renderer gradients as numpy arrays, in the order of the port's
    renderer parameters."""
    ref = jax_params_to_state_dict({**params, "renderer": jgrads}, pcfg)
    return [ref["renderer." + n].numpy() for n, _ in g.renderer.named_parameters()]


def _assert_near_jax(got, want, tol, what=""):
    """|got - want| <= rtol |want| + atol max |want|, entry by entry."""
    allowed = tol["rtol"] * np.abs(want) + tol["atol"] * np.abs(want).max()
    excess = np.abs(got - want) - allowed
    assert excess.max() <= 0, (what, float(excess.max()))


@pytest.mark.parametrize("field,remat,route", RENDER_CASES)
def test_jvp_eikonal_and_its_grads_match_jax(fields_jax, field, remat, route, monkeypatch):
    """The port's forward-mode term and the gradient of the eikonal loss of
    every renderer parameter against JAX's jvp mode, at its test's bars."""
    _assert_render_near_jax(fields_jax[field], field, remat, route, "jvp", monkeypatch)


def _assert_render_near_jax(fj, field, remat, route, mode, monkeypatch):
    g, pcfg, out, grads = _port_render(field, fj, remat, route, mode, monkeypatch)
    assert out.eikonal_term.shape == (BATCH, 4, 4, 3, 3)
    eik_tol, grad_tol = (FC_EIK_TOL, FC_GRAD_TOL) if field == "fc" else (EIK_TOL, GRAD_TOL)
    prefix = "" if mode == "jvp" else "vjp_"
    _assert_near_jax(out.eikonal_term.detach().numpy(), fj[prefix + "term"], eik_tol, "term")
    for (name, _), got, want in zip(g.renderer.named_parameters(), grads,
                                    _jax_grads(g, pcfg, fj["params"], fj[prefix + "grads"])):
        _assert_near_jax(got.numpy(), want, grad_tol, name)


@pytest.mark.parametrize("remat", [True, False])
def test_fc_vjp_stands_from_jax_within_the_fc_bars(fields_jax, remat, monkeypatch):
    """The FC field's reverse mode against JAX's at the FC bars: the
    distance that widens them is the field's forward, not the mode."""
    _assert_render_near_jax(fields_jax["fc"], "fc", remat, "passes", "vjp", monkeypatch)


@pytest.mark.parametrize("field,remat,route", RENDER_CASES)
def test_jvp_eikonal_and_its_grads_match_the_ports_vjp(fields_jax, field, remat, route,
                                                        monkeypatch):
    """Forward mode against the port's own reverse mode, the same bars; the
    rendered image is the same forward."""
    fj = fields_jax[field]
    _, _, out_j, grads_j = _port_render(field, fj, remat, route, "jvp", monkeypatch)
    _, _, out_v, grads_v = _port_render(field, fj, remat, route, "vjp", monkeypatch)
    np.testing.assert_allclose(out_j.eikonal_term.detach().numpy(),
                               out_v.eikonal_term.detach().numpy(), **EIK_TOL)
    np.testing.assert_allclose(out_j.rgb.detach().numpy(), out_v.rgb.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(grads_j, grads_v):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)


@pytest.mark.parametrize("remat", [True, False])
def test_stage_a_g_loss_and_every_grad_match_jax_in_jvp_mode(stage_a, remat):  # noqa: F811
    """The stage-A G loss with the full eikonal term, and every G gradient,
    with ``eikonal_mode="jvp"`` on both sides (``stage_a``'s SIREN)."""
    jcfg, pcfg = _configs_a(remat=remat, eikonal_mode="jvp")
    params, d_params = stage_a["params"], stage_a["d_params"]
    hp = j_steps.TrainHParams(batch=BATCH, style_dim=STYLE)
    jc, pc = _cams()
    z = _z(seed=11)
    (jl, (jg_gan, jeik, jms, _, _)), jgrads = jax.jit(jax.value_and_grad(
        _jax_stage_a_g_loss(jcfg, stage_a["dcfg_j"], hp, d_params, jnp.asarray(z), jc),
        has_aux=True))(params)
    g = _port_g(params, pcfg)
    d = _port_d(d_params, stage_a["dcfg_p"])
    loss, m = steps.stage_a_g_loss(g, d, pcfg, stage_a["dcfg_p"], steps.TrainHParams(
        batch=BATCH, style_dim=STYLE), steps.StepInputs(_t(z), pc))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    np.testing.assert_allclose(m["g"].item(), float(jg_gan), rtol=1e-4)
    np.testing.assert_allclose(m["g_eikonal"].item(), float(jeik), rtol=1e-4)
    np.testing.assert_allclose(m["g_minimal_surface"].item(), float(jms), rtol=1e-4, atol=1e-7)
    assert float(jeik) > 0
    _assert_grads(g, _grads(loss, g), jax_params_to_state_dict(jgrads, pcfg), rtol=1e-3)


@pytest.mark.parametrize("route", ["cpu_autograd", "function"])
def test_ngp_stage_a_g_loss_and_every_grad_match_jax_in_jvp_mode(ngp_a, route,  # noqa: F811
                                                                  monkeypatch):
    """The NGP stage-A G loss (eikonal through the encode's forward mode,
    hash smoothness) and every gradient, the table's included, through the
    CPU's autograd and through the card's encode ``Function``."""
    if route == "function":
        monkeypatch.setattr(siren, "hash_encode", _function_encode)
    jcfg, pcfg, jc, z, key, skey, inputs = _g_case(ngp_a, "full_remat", z_seed=11)
    jcfg = replace(jcfg, renderer=replace(jcfg.renderer, eikonal_mode="jvp"))
    pcfg = replace(pcfg, renderer=replace(pcfg.renderer, eikonal_mode="jvp"))
    hp = j_steps.TrainHParams(batch=BATCH, style_dim=STYLE)
    (jl, (jeik, jsmooth)), jgrads = jax.jit(jax.value_and_grad(
        _jax_ngp_g_loss(jcfg, ngp_a["dcfg_j"], hp, ngp_a["d_params"], jnp.asarray(z), jc,
                        key, skey), has_aux=True))(ngp_a["params"])
    g = _ngp_port_g(ngp_a["params"], pcfg)
    d = _ngp_port_d(ngp_a["d_params"], ngp_a["dcfg_p"])
    loss, m = steps.stage_a_g_loss(g, d, pcfg, ngp_a["dcfg_p"],
                                   steps.TrainHParams(batch=BATCH, style_dim=STYLE), inputs)
    np.testing.assert_allclose(m["g_eikonal"].item(), float(jeik), rtol=1e-4)
    np.testing.assert_allclose((loss - m["g_smooth"]).item(), float(jl - jsmooth), rtol=1e-4)
    assert float(jeik) > 0
    grads = torch.autograd.grad(loss, list(g.parameters()), allow_unused=True)
    _assert_ngp_grads(g, grads, jax_params_to_state_dict(jgrads, pcfg))


@pytest.mark.parametrize("field", list(FIELDS))
def test_jvp_with_eikonal_subsample_is_the_vjp(fields_jax, field):
    """``eikonal_subsample > 0`` ignores the mode, as in JAX: the same
    term and the same gradients, bit for bit."""
    fj = fields_jax[field]
    _, pc = _cams(seed=1)
    draws = (torch.from_numpy(np.random.default_rng(4).uniform(size=(BATCH, 16, 2))
                              .astype(np.float32)),
             torch.from_numpy(np.random.default_rng(5).uniform(size=(BATCH, 16))
                              .astype(np.float32)))
    outs = []
    for mode in ("vjp", "jvp"):
        _, pcfg = _field_configs(field, remat=False, eikonal_subsample=16, eikonal_mode=mode)
        g = _port_g(fj["params"], pcfg)
        out = renderer.render(g.renderer, pcfg.renderer, pc.focal, pc.extrinsics, pc.near,
                              pc.far, _t(fj["style"]), return_eikonal=True,
                              eikonal_draws=draws)
        loss = _eik_loss(out.eikonal_term) + out.rgb.mean()
        outs.append((out.eikonal_term, torch.autograd.grad(loss, list(g.renderer.parameters()),
                                                           allow_unused=True)))
    assert outs[0][0].shape == (BATCH, 16, 3)
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_fast_sin_lean_tangent_matches_forward_ad_of_fast_sin(dtype):
    """``_FastSin``'s ``jvp`` against forward AD through the plain
    polynomial (``round`` with a zero derivative), and reverse mode through
    that tangent against reverse over forward through the plain one."""
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.uniform(-40, 40, 257)).to(dtype)
    t = torch.from_numpy(rng.standard_normal(257)).to(dtype)
    w = torch.from_numpy(rng.standard_normal(257)).to(dtype)
    tans = []
    for fn in (fast_sin_lean, fast_sin):
        x = x0.clone().requires_grad_(True)
        with fwAD.dual_level():
            primal, tangent = fwAD.unpack_dual(fn(fwAD.make_dual(x, t)))
        (gx,) = torch.autograd.grad((tangent.float() * w.float()).sum(), x)
        tans.append((primal.detach(), tangent.detach(), gx))
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)
    for a, b in zip(*tans):
        assert a.dtype == dtype
        np.testing.assert_allclose(a.double().numpy(), b.double().numpy(), **tol)


ENCODE_CASES = [(dt, bound) for dt in (torch.float32, torch.bfloat16) for bound in (1.0, 2.0)]


def _encode_inputs(dtype, bound, n=300, seed=0):
    """Points a little beyond the box (some outside, some on its faces),
    tangents, a table at std 1 and a cotangent for the tangent."""
    spec = ph.HashGridSpec.create(num_levels=3, level_dim=2, base_resolution=4,
                                  desired_resolution=32, log2_hashmap_size=7)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.1 * bound, 1.1 * bound, (n, 3))
    x[:20, 0] = bound
    x = torch.from_numpy(x.astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    table = torch.from_numpy(rng.standard_normal((spec.table_size, 2)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n, spec.output_dim)).astype(np.float32))
    return spec, x, t, table.to(dtype), w


def _tangent_and_grads(encode, x, t, table, w):
    """The encode's tangent along ``t``, and the gradient of ``<w, tangent>``
    with respect to the table."""
    table = table.detach().requires_grad_(True)
    with fwAD.dual_level():
        tangent = fwAD.unpack_dual(encode(fwAD.make_dual(x, t), table)).tangent
    (d_table,) = torch.autograd.grad((tangent.float() * w).sum(), table)
    return tangent, d_table


@pytest.mark.parametrize("dtype,bound", ENCODE_CASES)
def test_hash_encode_function_tangent_and_its_grads_match_forward_ad(dtype, bound):
    """``_HashEncode``'s ``jvp`` (``_HashEncodeJvp`` over the plain version
    of K2 on the CPU) against forward AD through the plain encode: the
    tangent in the table's dtype and the table gradient of a loss on it.
    f32 ``rtol 1e-5`` (of
    the largest entry); bf16 one ulp of the f32 truth's norm (8e-3), as
    the kernels' bf16 contract."""
    spec, x, t, table, w = _encode_inputs(dtype, bound)
    geom = (spec, bound, tuple(range(spec.num_levels)))
    got = _tangent_and_grads(lambda xx, tt: ph._HashEncode.apply(xx, tt, geom), x, t, table, w)
    ref = _tangent_and_grads(
        lambda xx, tt: ph.hash_encode_reference(xx, tt.float(), spec, bound), x, t, table, w)
    assert got[0].dtype == dtype and got[1].dtype == dtype
    for a, b in zip(got, ref):
        a, b = a.detach().float(), b.detach().float()
        if dtype == torch.float32:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5 * b.abs().max().item())
        else:
            assert (a - b).norm() <= 8e-3 * b.norm()
    assert got[0][(x.abs() > bound).any(-1)].abs().max() == 0


@pytest.mark.parametrize("grid,bound,kind", [("tiny", 2.0, "spread"), ("wide", 1.0, "spread"),
                                             ("tuned_like", 1.0, "rays"),
                                             ("wide", 2.0, "mixed")])
def test_hash_encode_function_bf16_tangent_and_its_grads_match_jax(grid, bound, kind):
    """A bf16 table: ``_HashEncode``'s tangent and the table gradient of
    ``<w, tangent>`` against JAX's ``jax.jvp`` of its encode at bf16, within
    8e-3 of the norm (the kernels' bf16 contract), both in bf16, and no
    further from the f32 truth on the same rounded table than JAX's
    (1.2x + a floor; measured: the tangents equal, the table gradient's
    error 0.5-0.9x JAX's, which sums in bf16)."""
    j, p, table, x, w = _inputs(grid, bound, seed=6, kind=kind)
    t = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    t16 = jnp.asarray(table).astype(jnp.bfloat16)

    def tangent(tab):
        return jax.jvp(lambda xx: jh.hash_encode(xx, tab, j, bound=bound), (jnp.asarray(x),),
                       (jnp.asarray(t),))[1]

    def jax_pair(tab):
        grad = jax.grad(lambda tb: jnp.sum(tangent(tb).astype(jnp.float32) * w))(tab)
        return tangent(tab), grad

    want = jax_pair(t16)
    truth = jax_pair(t16.astype(jnp.float32))
    assert want[0].dtype == want[1].dtype == jnp.bfloat16
    geom = (p, bound, tuple(range(p.num_levels)))
    got = _tangent_and_grads(lambda xx, tt: ph._HashEncode.apply(xx, tt, geom), _t(x), _t(t),
                             _t(table).to(torch.bfloat16), _t(w))
    for ours, jax_bf16, f32 in zip(got, want, truth):
        assert ours.dtype == torch.bfloat16
        ours = ours.detach().float().numpy()
        jax_bf16, f32 = np.asarray(jax_bf16, np.float32), np.asarray(f32, np.float32)
        assert np.linalg.norm(ours - jax_bf16) <= 8e-3 * np.linalg.norm(jax_bf16)
        err_ours, err_jax = np.abs(ours - f32).mean(), np.abs(jax_bf16 - f32).mean()
        assert err_ours <= 1.2 * err_jax + 1e-6 * np.abs(f32).mean(), (err_ours, err_jax)


def test_hash_encode_function_refuses_a_tangent_of_the_table():
    spec, x, _, table, _ = _encode_inputs(torch.float32, 1.0, n=8)
    geom = (spec, 1.0, tuple(range(spec.num_levels)))
    with fwAD.dual_level():
        with pytest.raises(NotImplementedError, match="tangent of the points"):
            ph._HashEncode.apply(x, fwAD.make_dual(table, torch.ones_like(table)), geom)


def test_double_backward_gives_d_g_alone_without_g():
    """``hash_encode_double_backward(g=None, need_table=False)``: d g
    alone, equal to d g with any g; asking for the table without g raises."""
    spec, x, t, table, w = _encode_inputs(torch.float32, 2.0, n=64)
    _, dg = ph.hash_encode_double_backward(x, table, None, t, spec, 2.0, need_table=False)
    _, dg_w = ph.hash_encode_double_backward(x, table, w, t, spec, 2.0, need_table=False)
    assert dg.shape == (64, spec.output_dim) and torch.equal(dg, dg_w)
    with pytest.raises(ValueError, match="needs g"):
        ph.hash_encode_double_backward(x, table, None, t, spec, 2.0)


def test_jvp_refuses_the_fused_field(fields_jax):
    """The fused SIREN field has no forward mode: a jvp eikonal through it
    raises instead of running without its tangent."""
    _, pcfg = _field_configs("sdf", eikonal_mode="jvp", use_fused_kernel=True)
    g = _port_g(fields_jax["sdf"]["params"], pcfg)
    _, pc = _cams(seed=1)
    with pytest.raises(ValueError, match="no forward mode"):
        renderer.render(g.renderer, pcfg.renderer, pc.focal, pc.extrinsics, pc.near, pc.far,
                        _t(fields_jax["sdf"]["style"]), return_eikonal=True)


@pytest.mark.parametrize("mode,remat,field", [("vjp", True, "sdf"), ("jvp", True, "sdf"),
                                              ("jvp", False, "sdf"), ("jvp", True, "ngp")])
def test_bench_eikonal_mode_prints_the_jax_keys(mode, remat, field, capsys):
    """``scripts/torch_bench_eikonal_mode.py``'s measurement at a narrow
    config on the CPU: one line with the JAX script's keys and a finite
    step; the G loss does not depend on the mode."""
    import importlib.util
    import json
    import math
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_bench_eikonal_mode.py"
    spec = importlib.util.spec_from_file_location("torch_bench_eikonal_mode", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    lines = []
    for m, r in (("vjp", True), (mode, remat)):
        gcfg = bench.generator_config(m, r, field, res=8, samples=4, style=STYLE,
                                      widths={k: v for k, v in FIELDS[field].items()
                                              if k != "type"})
        lines.append(bench.measure(m, r, BATCH, iters=1, device="cpu", gcfg=gcfg))
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == [json.loads(json.dumps(ln)) for ln in lines]
    line = lines[1]
    assert {"eikonal_mode", "remat", "batch", "g_step_ms", "it_per_s", "g_loss"} <= set(line)
    assert (line["eikonal_mode"], line["remat"], line["batch"], line["field"]) == (
        mode, remat, BATCH, field)
    assert math.isfinite(line["g_step_ms"]) and line["g_step_ms"] > 0
    assert line["g_loss"] == pytest.approx(lines[0]["g_loss"], rel=1e-6)
