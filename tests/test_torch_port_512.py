"""The 512^2 configuration (``configs/512res/ffhq_512_sdf_tpu.yaml``) in the
port against the JAX package, on the CPU, at a width cut.

The yaml's own resolution (width 256, depth 8, 24 samples, bf16 G
parameters, 4,096 eikonal points, no remat) is held field by field by
``test_torch_port_config.py::test_stage_resolution_equals_the_jax_package``.
Here the 512^2 pyramid itself runs: the renderer at the yaml's 64^2 output
(three decoder doublings, ``n_latent`` 8, ``channel_table``'s 512 entry),
the StyleGAN2 D at size 512, and the three stage-B steps (D with R1, G,
path length), at field width 32, depth 2, 4 samples, style 16 and
``channel_base`` 16.  Weights come from the JAX initializers and cross by
the converters; inputs (z, cameras, real images, path noise) are made once
and given to both sides, without jitter and with the stored decoder noise.

Tolerances: images ``IMAGE_TOL`` (rtol 2e-3, atol 2e-4); D logits 1e-5 of
their largest magnitude; losses rel 1e-4 and each gradient's difference
1e-3 of its norm + 1e-6 (f32; the rule of ``test_torch_port_training.py``
and ``chip_smoke.masked_parity``: the noise strengths' scalar gradients sum
512^2 terms); with the yaml's bf16 G parameters, the bf16 contract
of ``tests/test_ops.py:346-381`` (the port's error against JAX's f32 result
at most 1.2x JAX's own bf16 error + 1e-4).  Then the two 512^2 benches'
lines, with the JAX scripts' keys, at a tiny size.
"""

import ast
import copy
import functools
import json
import os
from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdface_gan_tpu.geometry import generate_camera_params as j_cams  # noqa: E402
from sdface_gan_tpu.losses import gan_losses as j_gan  # noqa: E402
from sdface_gan_tpu.models import discriminator as j_disc  # noqa: E402
from sdface_gan_tpu.models import generator as j_gen  # noqa: E402
from sdface_gan_tpu.models import renderer as j_rend  # noqa: E402
from sdface_gan_tpu.models import stylegan2 as j_sg  # noqa: E402
from sdface_gan_tpu.training import steps as j_steps  # noqa: E402
from sdface_gan_tpu.utils.torch_import import import_generator_state  # noqa: E402
from sdface_gan_tpu_torch import bench_serving_512, bench_train_512  # noqa: E402
from sdface_gan_tpu_torch.geometry import CameraParams  # noqa: E402
from sdface_gan_tpu_torch.models import discriminator, generator, renderer  # noqa: E402
from sdface_gan_tpu_torch.training import steps  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import (  # noqa: E402
    jax_disc_params_to_state_dict,
    jax_params_to_state_dict,
)

from test_torch_port_models import IMAGE_TOL  # noqa: E402
from test_torch_port_training import _two_threads  # noqa: E402,F401  (autouse: two threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, RES, SAMPLES, WIDTH, DEPTH, STYLE, BASE, BATCH = 512, 64, 4, 32, 2, 16, 16, 2
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3, 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _configs(**kw):
    """The 512^2 stage-B generator at the width cut, in both packages."""
    rkw = dict(type="sdf", out_im_res=RES, n_samples=SAMPLES, style_dim=STYLE, width=WIDTH,
               depth=DEPTH)
    gkw = dict(size=SIZE, style_dim=STYLE, full_pipeline=True, freeze_renderer=True,
               channel_base=BASE, **kw)
    return (j_gen.GeneratorConfig(renderer=j_rend.RendererConfig(**rkw), **gkw),
            generator.GeneratorConfig(renderer=renderer.RendererConfig(**rkw), **gkw))


@pytest.fixture(scope="module")
def m512():
    """One 512^2 generator and D, both sides: the port's generator init
    carried to JAX by the JAX package's ``import_generator_state`` (its
    eager init at this size costs ~30 s), the D drawn N(0, 1) into JAX's
    tree; each crosses to the port by the converters."""
    jcfg, pcfg = _configs()
    g0 = generator.Generator(pcfg, device="cpu", generator=torch.Generator().manual_seed(51))
    params = import_generator_state({k: v.numpy() for k, v in g0.state_dict().items()},
                                    "sdf", depth=DEPTH)
    dcfg_j = j_disc.StyleDiscConfig(size=SIZE, channel_base=BASE)
    dcfg_p = discriminator.StyleDiscConfig(size=SIZE, channel_base=BASE)
    rng = np.random.default_rng(52)
    d_params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        jax.eval_shape(lambda k: j_disc.init_style_discriminator(k, dcfg_j),
                       jax.random.PRNGKey(0)))
    g = generator.Generator(pcfg, device="cpu")
    g.load_state_dict(jax_params_to_state_dict(params, pcfg))
    d = discriminator.StyleDiscriminator(dcfg_p)
    d.load_state_dict(jax_disc_params_to_state_dict(d_params))
    jc = jax.jit(j_cams, static_argnums=(0, 2))(RES, jax.random.PRNGKey(53), BATCH)
    rng = np.random.default_rng(54)
    z1, z2 = (rng.standard_normal((BATCH, STYLE)).astype(np.float32) for _ in range(2))
    real = rng.uniform(-1, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    noise = (rng.standard_normal((BATCH // 2, SIZE, SIZE, 3)) / SIZE).astype(np.float32)
    return dict(jcfg=jcfg, pcfg=pcfg, params=params, dcfg_j=dcfg_j, dcfg_p=dcfg_p,
                d_params=d_params, g=g, d=d, jc=jc, pc=CameraParams(*[_t(x) for x in jc]),
                z1=z1, z2=z2, idx=3, real=real, noise=noise, jax={})


def _once(fn):
    """Each JAX reference computed once per (step, dtype) for the module."""
    def cached(m, *args):
        key = (fn.__name__,) + args
        if key not in m["jax"]:
            m["jax"][key] = fn(m, *args)
        return m["jax"][key]
    return cached


def test_the_cut_keeps_the_512_pyramid(m512):
    """Three doublings from the renderer's 64^2, eight latents, the 512
    entry of ``channel_table`` (base // 16 * multiplier) on both sides."""
    jdec, pdec = m512["jcfg"].decoder, m512["pcfg"].decoder
    assert (pdec.size, pdec.in_res, pdec.n_latent) == (512, 64, 8) == (
        jdec.size, jdec.in_res, jdec.n_latent)
    assert pdec.channels == jdec.channels and pdec.channels[512] == BASE // 16 * 2
    assert len(m512["g"].decoder.convs) == 2 * 3 == len(m512["params"]["decoder"]["convs"])


def test_generator_forward_at_512_matches_jax(m512):
    """The whole forward at batch 1: renderer at 64^2, the decoder to 512^2
    (the skip ``to_rgb`` upsampled three times)."""
    jc, pc = m512["jc"], m512["pc"]
    z = m512["z1"][:1]
    ref = jax.jit(lambda p, z: j_gen.generator_forward(
        p, m512["jcfg"], [z], jc.extrinsics[:1], jc.focal[:1], jc.near[:1], jc.far[:1],
        randomize_noise=False))(m512["params"], jnp.asarray(z))
    with torch.no_grad():
        out = generator.generator_forward(m512["g"], m512["pcfg"], [_t(z)], pc.extrinsics[:1],
                                          pc.focal[:1], pc.near[:1], pc.far[:1],
                                          randomize_noise=False)
    assert tuple(out.rgb.shape) == (1, SIZE, SIZE, 3)
    np.testing.assert_allclose(out.rgb.numpy(), np.asarray(ref.rgb), **IMAGE_TOL)
    np.testing.assert_allclose(out.thumb_rgb.numpy(), np.asarray(ref.thumb_rgb), **IMAGE_TOL)


def test_style_discriminator_at_512_matches_jax(m512):
    x = np.random.default_rng(55).uniform(-1, 1, (4, SIZE, SIZE, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: j_disc.apply_style_discriminator(
        p, m512["dcfg_j"], x))(m512["d_params"], jnp.asarray(x)))
    with torch.no_grad():
        ours = m512["d"](_t(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


# ---------------------------------------------------------------------------
# The stage-B steps at 512^2
# ---------------------------------------------------------------------------

def _cast(params, dtype):
    return j_steps._cast_params(params, None if dtype == "float32" else jnp.dtype(dtype))


def _jax_fake(m, dtype):
    """The D step's fakes from the G parameters in ``dtype``: jitted in f32;
    in bf16 op by op, since XLA on the CPU keeps a jitted bf16 graph's
    intermediates in f32 (its D loss then sits 2.2e-5 from f32's where op-by-op
    rounding, the bf16 contract's reference path, puts it further)."""
    jc = m["jc"]

    def forward(p, z1, z2):
        return j_gen.generator_forward(p, m["jcfg"], [z1, z2], jc.extrinsics, jc.focal, jc.near,
                                       jc.far, inject_index=m["idx"],
                                       randomize_noise=False).rgb.astype(jnp.float32)

    if dtype == "float32":
        forward = jax.jit(forward)
    return forward(_cast(m["params"], dtype), jnp.asarray(m["z1"]), jnp.asarray(m["z2"]))


@functools.lru_cache(maxsize=None)
def _jax_d_loss_and_grad(dcfg):
    """JAX's stage-B D loss with R1 as ``make_stage_b_d_step`` computes it,
    of (D params, fakes, reals): one compilation for the f32 and bf16 fakes."""
    hp = j_steps.TrainHParams(batch=BATCH, style_dim=STYLE)

    def loss(dp, fake, real):
        apply = lambda img: j_disc.apply_style_discriminator(dp, dcfg, img)  # noqa: E731
        real_pred, pen = j_gan.d_logits_and_r1(apply, real)
        return j_gan.d_logistic_loss(real_pred, apply(fake)) + hp.r1 * 0.5 * pen * hp.d_reg_every

    return jax.jit(jax.value_and_grad(loss))


@_once
def _jax_d(m, dtype):
    """JAX's stage-B D loss with R1 and its gradients, the fakes made with
    the G parameters in ``dtype``."""
    loss_val, grads = _jax_d_loss_and_grad(m["dcfg_j"])(m["d_params"], _jax_fake(m, dtype),
                                                        jnp.asarray(m["real"]))
    return float(loss_val), jax_disc_params_to_state_dict(grads)


@_once
def _jax_g(m, dtype):
    """JAX's stage-B G loss and its decoder gradients (``make_stage_b_g_step``'s
    loss on given inputs)."""
    jc = m["jc"]

    def loss(gp):
        out = j_gen.generator_forward(_cast(gp, dtype), m["jcfg"],
                                      [jnp.asarray(m["z1"]), jnp.asarray(m["z2"])],
                                      jc.extrinsics, jc.focal, jc.near, jc.far,
                                      inject_index=m["idx"], randomize_noise=False)
        g_gan = j_gan.g_nonsaturating_loss(j_disc.apply_style_discriminator(
            m["d_params"], m["dcfg_j"], out.rgb))
        up = jnp.repeat(jnp.repeat(out.thumb_rgb, SIZE // RES, axis=1), SIZE // RES, axis=2)
        return g_gan + 0.001 * j_gan.g_content_loss(out.rgb, up)

    loss_val, grads = jax.jit(jax.value_and_grad(loss))(m["params"])
    return float(loss_val), _decoder_grads(grads, m["pcfg"])


def _decoder_grads(grads, pcfg):
    ref = jax_params_to_state_dict(grads, pcfg)
    return {k[len("decoder."):]: v for k, v in ref.items() if k.startswith("decoder.")}


@_once
def _jax_path(m, dtype):
    """JAX's path-length step loss on a shrunk batch (f32 in both packages'
    training; here also f64, under ``jax.enable_x64``): the frozen
    renderer's features, mixed latents, fixed projection noise, the running
    mean at a fresh run's 0."""
    f = np.dtype(dtype)
    cast = lambda x: jnp.asarray(np.asarray(x, dtype=f))  # noqa: E731
    with jax.enable_x64(dtype == "float64"):
        jc = jax.tree_util.tree_map(cast, m["jc"])
        b = BATCH // 2
        hp = j_steps.TrainHParams(batch=BATCH, style_dim=STYLE)
        z1, z2 = cast(m["z1"][:b]), cast(m["z2"][:b])

        def loss(gp):
            feats = jax.lax.stop_gradient(j_rend.render(
                gp["renderer"], m["jcfg"].renderer, jc.focal[:b], jc.extrinsics[:b],
                jc.near[:b], jc.far[:b], j_gen.map_style(gp, z1)).features)
            dcfg = m["jcfg"].decoder
            latent = j_sg.make_decoder_latent(gp["decoder"], dcfg, [j_gen.map_style(gp, z1),
                                                                    j_gen.map_style(gp, z2)],
                                              inject_index=m["idx"])
            pen, new_mean, lengths = j_gan.g_path_regularize(
                lambda lat: j_sg.apply_decoder(gp["decoder"], dcfg, feats, lat), latent,
                jnp.zeros((), f), noise=cast(m["noise"]))
            return hp.path_regularize * hp.g_reg_every * pen, (new_mean, jnp.mean(lengths))

        params = jax.tree_util.tree_map(cast, m["params"])
        (loss_val, (new_mean, length)), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(params)
        return float(loss_val), (float(new_mean), float(length)), _decoder_grads(
            jax.tree_util.tree_map(np.asarray, grads), m["pcfg"])


def _port_inputs(m, b=BATCH, **kw):
    pc = m["pc"]
    cams = CameraParams(*[x[:b] for x in pc])
    return steps.StepInputs(_t(m["z1"][:b]), cams, _t(m["z2"][:b]), m["idx"], **kw)


def _port_d(m, dtype):
    d = m["d"]
    hp = steps.TrainHParams(batch=BATCH, style_dim=STYLE, g_param_dtype=dtype)
    loss, metrics = steps.stage_b_d_loss(m["g"], d, m["pcfg"], m["dcfg_p"], hp, _t(m["real"]),
                                         _port_inputs(m), regularize=True)
    assert "r1" in metrics
    names = [n for n, _ in d.named_parameters()]
    return loss.item(), dict(zip(names, torch.autograd.grad(loss, list(d.parameters()))))


def _port_g(m, dtype):
    g = m["g"]
    hp = steps.TrainHParams(batch=BATCH, style_dim=STYLE, g_param_dtype=dtype)
    loss, _ = steps.stage_b_g_loss(g, m["d"], m["pcfg"], m["dcfg_p"], hp, _port_inputs(m))
    dec = dict(g.decoder.named_parameters())
    grads = torch.autograd.grad(loss, list(dec.values()), allow_unused=True)
    return loss.item(), {n: (torch.zeros_like(p) if gr is None else gr)
                         for (n, p), gr in zip(dec.items(), grads)}


def _port_path(m, dtype):
    dt = getattr(torch, dtype)
    g = m["g"] if dtype == "float32" else copy.deepcopy(m["g"]).to(dt)
    hp = steps.TrainHParams(batch=BATCH, style_dim=STYLE)
    b = BATCH // 2
    cams = CameraParams(*[x[:b].to(dt) for x in m["pc"]])
    inputs = steps.StepInputs(_t(m["z1"][:b]).to(dt), cams, _t(m["z2"][:b]).to(dt), m["idx"],
                              path_noise=_t(m["noise"]).to(dt))
    loss, new_mean, metrics = steps.stage_b_path_loss(g, m["pcfg"], hp, inputs,
                                                      torch.zeros((), dtype=dt))
    dec = dict(g.decoder.named_parameters())
    grads = torch.autograd.grad(loss, list(dec.values()), allow_unused=True)
    return loss.item(), (new_mean.item(), metrics["path_length"].item()), {
        n: (torch.zeros_like(p) if gr is None else gr) for (n, p), gr in zip(dec.items(), grads)}


def _grad_excess(ours: dict, ref: dict) -> dict:
    """Each gradient's ||ours - ref|| over its bound, GRAD_RTOL ||ref|| +
    GRAD_ATOL (the parameters; a converted JAX tree also holds the stored
    decoder noise)."""
    return {n: ((ours[n] - ref[n]).norm() / (GRAD_RTOL * ref[n].norm() + GRAD_ATOL)).item()
            for n in ours}


def _total_rel(ours: dict, ref: dict) -> float:
    ref = {n: ref[n] for n in ours}
    num = sum(((ours[n] - ref[n]).norm() ** 2).item() for n in ref) ** 0.5
    return num / sum((ref[n].norm() ** 2).item() for n in ref) ** 0.5


def _worst_rel(ours: dict, ref: dict) -> float:
    return max(((ours[n].double() - ref[n].double()).norm()
                / (ref[n].double().norm() + 1e-30)).item() for n in ours)


@pytest.mark.parametrize("step", ["d_r1", "g"])
def test_stage_b_step_at_512_matches_jax_in_f32(m512, step):
    """Loss rel 1e-4 and each gradient (the D's, or the decoder's) within 1e-3
    of its norm + 1e-6."""
    jl, jg = (_jax_d if step == "d_r1" else _jax_g)(m512, "float32")
    pl, pg = (_port_d if step == "d_r1" else _port_g)(m512, "float32")
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    excess = _grad_excess(pg, jg)
    worst = max(excess, key=excess.get)
    assert excess[worst] <= 1.0, (worst, excess[worst])


def test_stage_b_path_step_at_512_matches_jax(m512):
    """The path-length step (f32 in training), whose gradients at 512^2 are
    sums of 512^2 products with cancellation: JAX's own f32 gradients lie up
    to ~1e-2 of their norm from its f64 ones.  So in f64 (JAX under
    ``jax.enable_x64``, the port's modules in double) the two packages agree
    within loss rel 1e-6 and 1e-4 of each gradient's norm; in f32 the port's
    loss, running mean and length are within rel 1e-4 of that f64 truth, and
    its worst gradient is no further from it than JAX's f32 worst, by the
    rule of the bf16 contract (1.2x + 1e-4)."""
    jl64, jstats64, jg64 = _jax_path(m512, "float64")
    pl64, pstats64, pg64 = _port_path(m512, "float64")
    np.testing.assert_allclose([pl64, *pstats64], [jl64, *jstats64], rtol=1e-6)
    assert _worst_rel(pg64, jg64) <= 1e-4, _worst_rel(pg64, jg64)
    _, _, jg32 = _jax_path(m512, "float32")
    pl32, pstats32, pg32 = _port_path(m512, "float32")
    np.testing.assert_allclose([pl32, *pstats32], [jl64, *jstats64], rtol=LOSS_RTOL)
    worst_jax, worst_port = _worst_rel(jg32, jg64), _worst_rel(pg32, jg64)
    assert worst_port <= 1.2 * worst_jax + 1e-4, (worst_port, worst_jax)


@pytest.mark.parametrize("step", ["d_r1", "g"])
def test_stage_b_step_at_512_with_bf16_g_meets_the_bf16_contract(m512, step):
    """The yaml's ``g_param_dtype: bfloat16`` (the path step stays f32 in both
    packages): the port's loss and gradients are no further from JAX's f32
    ones than JAX's own bf16 step is, by the rule of the bf16 contract."""
    jfn, pfn = (_jax_d, _port_d) if step == "d_r1" else (_jax_g, _port_g)
    l32, g32 = jfn(m512, "float32")
    l16, g16 = jfn(m512, "bfloat16")
    pl, pg = pfn(m512, "bfloat16")
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v).all()) for v in pg.values())
    err_jax, err_port = abs(l16 - l32), abs(pl - l32)
    assert 0 < err_jax and err_port <= 1.2 * err_jax + 1e-4, (err_port, err_jax)
    gerr_jax, gerr_port = _total_rel(g16, g32), _total_rel(pg, g32)
    assert 0 < gerr_jax and gerr_port <= 1.2 * gerr_jax + 1e-4, (gerr_port, gerr_jax)


# ---------------------------------------------------------------------------
# The benches
# ---------------------------------------------------------------------------

def _jax_script_keys(path: str) -> set:
    """The constant keys the JAX script's ``main`` writes into its lines:
    dict literals' and ``row["..."] = `` subscripts'."""
    main = next(n for n in ast.parse(open(path).read()).body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys if isinstance(k, ast.Constant)}
        elif isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store) \
                and isinstance(node.slice, ast.Constant):
            keys.add(node.slice.value)
    return keys - {"error"}  # written only on a miss


def _lines(capsys) -> list:
    out = capsys.readouterr().out.splitlines()
    return [json.loads(ln) for ln in out if ln.startswith("{")]


def test_the_benches_build_the_yaml_at_512():
    gcfg = bench_serving_512.config_512()
    tcfg, dcfg, hp = bench_train_512.configs_512()
    r = gcfg.renderer
    assert gcfg == tcfg and (gcfg.size, dcfg.size, hp.g_param_dtype) == (512, 512, "bfloat16")
    assert (r.width, r.depth, r.n_samples, r.out_im_res) == (256, 8, 24, 64)
    assert (bench_serving_512.BATCHES, bench_train_512.BATCHES) == ((4, 8, 16, 32), (2, 4, 8))


def test_bench_serving_512_prints_a_line_per_batch_with_the_jax_keys(monkeypatch, capsys):
    _, pcfg = _configs()
    tiny = replace(pcfg, size=128, renderer=replace(pcfg.renderer, out_im_res=16))
    monkeypatch.setattr(bench_serving_512, "config_512", lambda: tiny)
    monkeypatch.setattr(bench_serving_512, "WARMUP", 1)
    monkeypatch.setattr(bench_serving_512, "ITERS", 2)
    rows = bench_serving_512.main(["1", "2", "--device", "cpu"])
    lines = _lines(capsys)
    assert lines == rows and [r["batch"] for r in rows] == [1, 2]
    want = _jax_script_keys(os.path.join(REPO, "scripts", "bench_serving_512.py"))
    for r in rows:
        assert want <= set(r) and "peak_memory_gb" in r, want - set(r)
        assert r["bench"] == "512x512 serving forward" and r["fits_hbm"] and r["finite"]
        assert r["img_per_s"] > 0 and r["shape"] == [r["batch"], 128, 128, 3]
        assert r["ms_per_batch"] == pytest.approx(1e3 * r["batch"] / r["img_per_s"])


def test_bench_train_512_prints_a_line_per_batch_with_the_jax_keys(monkeypatch, capsys):
    _, pcfg = _configs()
    tiny = replace(pcfg, size=128, renderer=replace(pcfg.renderer, out_im_res=16))
    _, dcfg, hp = bench_train_512.configs_512()
    monkeypatch.setattr(bench_train_512, "configs_512", lambda: (
        tiny, replace(dcfg, size=128, channel_base=BASE), replace(hp, style_dim=STYLE)))
    monkeypatch.setattr(bench_train_512, "ITERS", 2)
    rows = bench_train_512.main(["2", "--device", "cpu"])
    lines = _lines(capsys)
    assert lines == rows and [r["batch"] for r in rows] == [2]
    want = _jax_script_keys(os.path.join(REPO, "scripts", "bench_train_512.py"))
    r = rows[0]
    assert want <= set(r), want - set(r)
    assert r["bench"] == "512x512 stage-B steps" and r["g_param_dtype"] == "bfloat16"
    assert r["fits_hbm"] and r["finite"] and r["peak_hbm_gb"] is None  # the CPU has no peak
    assert r["it_per_s_combined"] == pytest.approx(
        1e3 / (r["d_r1_ms"] + r["g_ms"] + r["path_ms"] / hp.g_reg_every))
