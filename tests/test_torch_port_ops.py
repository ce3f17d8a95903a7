"""The port's ops (``sdface_gan_tpu_torch.ops``) against the JAX package.

Inputs come from ``np.random.default_rng``; the JAX side runs as the JAX
tests run it (Pallas in interpret mode on the CPU).  The fused field's
CUDA kernel runs only on a card: its cases are in
``test_torch_port_cuda.py``, which imports no JAX.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdface_gan_tpu.models.siren import (  # noqa: E402
    SirenConfig as JSirenConfig,
    apply_siren_generator,
    init_siren_generator,
)
from sdface_gan_tpu.ops import fused_act as j_act  # noqa: E402
from sdface_gan_tpu.ops import transcendental as j_tr  # noqa: E402
from sdface_gan_tpu.ops.upfirdn2d import (  # noqa: E402
    blur as j_blur,
    make_kernel as j_make_kernel,
    upfirdn2d as j_upfirdn2d,
    upsample2d as j_upsample2d,
)
from sdface_gan_tpu.ops.siren_kernel import siren_field_fused  # noqa: E402
from sdface_gan_tpu_torch.models.generator import GeneratorConfig  # noqa: E402
from sdface_gan_tpu_torch.models.renderer import RendererConfig  # noqa: E402
from sdface_gan_tpu_torch.models.siren import SirenConfig, SirenGenerator  # noqa: E402
from sdface_gan_tpu_torch.ops import fused_act, transcendental  # noqa: E402
from sdface_gan_tpu_torch.ops import siren_kernel  # noqa: E402
from sdface_gan_tpu_torch.ops.upfirdn2d import (  # noqa: E402
    blur,
    make_kernel,
    upfirdn2d,
    upsample2d,
)
from sdface_gan_tpu_torch.utils.convert import jax_params_to_state_dict  # noqa: E402

BLUR = (1.0, 3.0, 3.0, 1.0)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


# ------------------------------------------------------------------ fast_sin
@pytest.mark.parametrize("name", ["fast_sin", "fast_cos"])
def test_fast_sin_cos_match_numpy_and_jax(name):
    x = np.linspace(-100.0, 100.0, 200001, dtype=np.float32)
    ours = getattr(transcendental, name)(torch.from_numpy(x)).numpy()
    exact = np.sin(x) if name == "fast_sin" else np.cos(x)
    # f32 round-based range reduction loses ~1e-5 at |x| ~ 100
    np.testing.assert_allclose(ours, exact, atol=2e-5)
    ref = np.asarray(getattr(j_tr, name)(jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_fast_sin_reduces_in_f32_for_bf16_input():
    x = np.linspace(-100.0, 100.0, 4001, dtype=np.float32)
    ours = transcendental.fast_sin(torch.from_numpy(x).bfloat16())
    assert ours.dtype == torch.bfloat16
    ref = np.asarray(j_tr.fast_sin(jnp.asarray(x, jnp.bfloat16))).astype(np.float32)
    # same f32 math on the same bf16 inputs; outputs differ by at most one
    # bf16 rounding step (2^-8 near 1)
    np.testing.assert_allclose(ours.float().numpy(), ref, atol=2.0**-8)


# ---------------------------------------------------------- fused_leaky_relu
@pytest.mark.parametrize("shape,scale", [((2, 4, 4, 5), 2**0.5), ((3, 7), 1.0)])
def test_fused_leaky_relu_matches_jax(shape, scale):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    ref = np.asarray(j_act.fused_leaky_relu(jnp.asarray(x), jnp.asarray(b), scale=scale))
    if len(shape) == 4:  # the port is channel-first
        ours = _nhwc(fused_act.fused_leaky_relu(_nchw(x), torch.from_numpy(b), scale=scale))
    else:
        ours = fused_act.fused_leaky_relu(torch.from_numpy(x), torch.from_numpy(b),
                                          scale=scale).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- upfirdn2d
@pytest.mark.parametrize("case", ["up2_pad", "down2", "upsample2d", "blur", "blur_up"])
def test_upfirdn2d_family_matches_jax(case):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 9, 3)).astype(np.float32)
    xj, xt = jnp.asarray(x), _nchw(x)
    if case == "up2_pad":
        ref = j_upfirdn2d(xj, j_make_kernel(jnp.asarray(BLUR)) * 4.0, up=2, pad=(2, 1))
        ours = upfirdn2d(xt, make_kernel(BLUR) * 4.0, up=2, pad=(2, 1))
    elif case == "down2":
        ref = j_upfirdn2d(xj, j_make_kernel(jnp.asarray(BLUR)), down=2, pad=(1, 1))
        ours = upfirdn2d(xt, make_kernel(BLUR), down=2, pad=(1, 1))
    elif case == "upsample2d":
        ref = j_upsample2d(xj, jnp.asarray(BLUR))
        ours = upsample2d(xt, BLUR)
    elif case == "blur":
        ref = j_blur(xj, jnp.asarray(BLUR), (1, 1))
        ours = blur(xt, BLUR, (1, 1))
    else:  # the modulated conv's up path: negative trailing pad crops
        ref = j_blur(xj, jnp.asarray(BLUR), (1, -1), upsample_factor=2)
        ours = blur(xt, BLUR, (1, -1), upsample_factor=2)
    ref = np.asarray(ref)
    assert _nhwc(ours).shape == ref.shape
    np.testing.assert_allclose(_nhwc(ours), ref, atol=1e-5)


# -------------------------------------------------------- the fused field
DEPTH, WIDTH, STYLE, P = 3, 256, 64, 700  # the shapes of test_ops.py:326-343


def _port_siren(params, dtype=torch.float32):
    """The port's SirenGenerator carrying a JAX SIREN parameter tree."""
    cfg = GeneratorConfig(
        style_dim=STYLE, full_pipeline=False,
        renderer=RendererConfig(style_dim=STYLE, width=WIDTH, depth=DEPTH))
    tree = {"mapping": [], "renderer": {"network": params}}
    prefix = "renderer.network."
    sd = {k[len(prefix):]: v for k, v in jax_params_to_state_dict(tree, cfg).items()}
    net = SirenGenerator(SirenConfig(depth=DEPTH, width=WIDTH, style_dim=STYLE))
    net.load_state_dict(sd)
    return net.to(dtype)


@pytest.fixture(scope="module")
def field_case():
    jcfg = JSirenConfig(depth=DEPTH, width=WIDTH, style_dim=STYLE)
    params = init_siren_generator(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(3)
    pts = (rng.standard_normal((2, P, 3)) * 0.5).astype(np.float32)
    views = rng.standard_normal((2, P, 3)).astype(np.float32)
    style = rng.standard_normal((2, STYLE)).astype(np.float32)
    return jcfg, params, pts, views, style


def _port_field(net, pts, views, style, fn):
    with torch.no_grad():
        pack = siren_kernel.pack_siren_field(net)
        gamma, beta = siren_kernel.film_coeffs(net, torch.from_numpy(style))
        rgb, sdf, feat = fn(pack, torch.from_numpy(pts), torch.from_numpy(views), gamma, beta)
    return torch.cat([rgb, sdf, feat.float()], -1).numpy()


@pytest.mark.parametrize("target", ["pallas_interpret", "xla"])
def test_field_plain_version_matches_jax_f32(field_case, target):
    jcfg, params, pts, views, style = field_case
    if target == "pallas_interpret":
        ref = siren_field_fused(params, pts, views, style, depth=DEPTH, width=WIDTH,
                                interpret=True, dot_dtype=jnp.float32)
    else:
        ref = apply_siren_generator(params, jcfg, pts, views, style)
    net = _port_siren(params)
    ours = _port_field(net, pts, views, style, siren_kernel.siren_field_reference)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-3, atol=1e-3)
    # on a CPU tensor the wrapper is the plain version
    wrapped = _port_field(net, pts, views, style, siren_kernel.siren_field_fused_parts)
    np.testing.assert_array_equal(wrapped, ours)


def test_field_bf16_quality_contract(field_case):
    """bf16 weights (bf16 operands, f32 accumulate, bf16 gamma heads): the
    error against f32 truth is no worse than the JAX bf16 path's, the rule
    of test_ops.py:346-381."""
    jcfg, params, pts, views, style = field_case
    truth = np.asarray(apply_siren_generator(params, jcfg, pts, views, style))
    p16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), params)
    xla16 = np.asarray(apply_siren_generator(p16, jcfg, pts, views, style)).astype(np.float32)
    net16 = _port_siren(params, torch.bfloat16)
    ours = _port_field(net16, pts, views, style, siren_kernel.siren_field_reference)
    err_xla = np.mean(np.abs(xla16 - truth))
    err_ours = np.mean(np.abs(ours - truth))
    assert err_ours <= 1.2 * err_xla + 1e-4, (err_ours, err_xla)
    assert err_ours < 0.05, err_ours


def test_fused_field_refuses_grad(field_case):
    _, params, pts, views, style = field_case
    net = _port_siren(params)
    pack = siren_kernel.pack_siren_field(net)
    with torch.no_grad():
        gamma, beta = siren_kernel.film_coeffs(net, torch.from_numpy(style))
    with pytest.raises(RuntimeError, match="no backward"):
        siren_kernel.siren_field_fused_parts(
            pack, torch.from_numpy(pts), torch.from_numpy(views), gamma, beta)


def test_field_kernel_is_chosen_by_dot_dtype():
    """bf16 runs on the tensor cores, f32 on the FMA pipes; nothing else."""
    assert siren_kernel.kernel_name(torch.bfloat16) == "siren_field_mma_kernel"
    assert siren_kernel.kernel_name(torch.float32) == "siren_field_f32_kernel"
    with pytest.raises(ValueError, match="dot dtype"):
        siren_kernel.kernel_name(torch.float16)


def _small_field(width, dtype=torch.bfloat16, depth=2, p=5):
    net = SirenGenerator(SirenConfig(depth=depth, width=width, style_dim=8),
                         generator=torch.Generator().manual_seed(0)).to(dtype)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.standard_normal((2, p, 3)).astype(np.float32))
    style = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    with torch.no_grad():
        pack = siren_kernel.pack_siren_field(net)
        gamma, beta = siren_kernel.film_coeffs(net, style)
    return pack, pts, pts.clone(), gamma, beta


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("case", ["ok_64", "ok_192", "ok_512", "ok_f32", "width_32",
                                  "width_576", "width_96", "f16", "misaligned_weight",
                                  "misaligned_gamma"])
def test_field_kernel_input_checks(case):
    """What the CUDA wrapper checks before a launch, run on CPU tensors:
    widths 64..512 in steps of 64 for both kernels, a bf16 or f32 dot dtype,
    16-byte aligned weights and FiLM tensors (the kernels' vector copies)."""
    width = {"ok_192": 192, "ok_512": 512, "width_32": 32, "width_576": 576,
             "width_96": 96}.get(case, 64)
    dtype = torch.float32 if case == "ok_f32" else torch.bfloat16
    pack, pts, views, gamma, beta = _small_field(width, dtype)
    if case == "f16":  # the dot dtype is the packed weights' dtype
        pack = dataclasses.replace(pack, w_first=pack.w_first.half())
    if case == "misaligned_weight":
        pack = dataclasses.replace(pack, w_hidden=_misaligned(pack.w_hidden))
        assert pack.w_hidden.is_contiguous() and pack.w_hidden.data_ptr() % 16
    if case == "misaligned_gamma":
        gamma = _misaligned(gamma)
    match = {"width_32": "widths", "width_576": "widths", "width_96": "widths",
             "f16": "dot dtype", "misaligned_weight": "aligned",
             "misaligned_gamma": "aligned"}.get(case)
    if match is None:
        siren_kernel._check_inputs(pack, pts, views, gamma, beta)
    else:
        with pytest.raises(ValueError, match=match):
            siren_kernel._check_inputs(pack, pts, views, gamma, beta)
