"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports torch and the port only, no JAX, so that it runs on a machine
without JAX:

    python -m pytest tests/test_torch_port_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest configures JAX.)
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdface_gan_tpu_torch.models.generator import Generator, GeneratorConfig  # noqa: E402
from sdface_gan_tpu_torch.models.renderer import RendererConfig  # noqa: E402
from sdface_gan_tpu_torch.models.siren import SirenConfig, SirenGenerator  # noqa: E402
from sdface_gan_tpu_torch.ops import _ext, siren_kernel  # noqa: E402
from sdface_gan_tpu_torch.serving import SDFaceSampler  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the port's CUDA kernels need an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _field_args(dtype, depth=3, width=256, style_dim=64, p=700, seed=0):
    net = SirenGenerator(SirenConfig(depth=depth, width=width, style_dim=style_dim),
                         generator=torch.Generator().manual_seed(seed)).cuda().to(dtype)
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy((rng.standard_normal((2, p, 3)) * 0.5).astype(np.float32)).cuda()
    views = torch.from_numpy(rng.standard_normal((2, p, 3)).astype(np.float32)).cuda()
    style = torch.from_numpy(rng.standard_normal((2, style_dim)).astype(np.float32)).cuda()
    with torch.no_grad():
        pack = siren_kernel.pack_siren_field(net)
        gamma, beta = siren_kernel.film_coeffs(net, style)
    return pack, pts, views, gamma, beta


@pytest.mark.parametrize("dot_dtype", ["float32", "bfloat16"])
def test_field_kernel_matches_plain_version(cuda, dot_dtype):
    """Depth 3, width 256, P=700 (a partial last tile)."""
    args = _field_args(getattr(torch, dot_dtype))
    with torch.no_grad():
        before = _ext.LAUNCHES["siren_field"]
        got = siren_kernel.siren_field_fused_parts(*args)
        torch.cuda.synchronize()
        assert _ext.LAUNCHES["siren_field"] == before + 1
        want = siren_kernel.siren_field_reference(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        # f32: only the summation order differs.  bf16: the same rounding
        # points, but an accumulator ulp that flips a bf16 rounding of h
        # moves the next layer's phase by gamma (~30) times 2^-8 at most.
        tol = 1e-3 if dot_dtype == "float32" else 5e-2
        np.testing.assert_allclose(g.float().cpu().numpy(), w.float().cpu().numpy(),
                                   rtol=tol, atol=tol)


def test_field_kernel_rejects_what_it_does_not_take(cuda):
    pack, pts, views, gamma, beta = _field_args(torch.float32)
    with torch.no_grad():
        with pytest.raises(ValueError, match="contiguous"):
            siren_kernel.siren_field_fused_parts(pack, pts.transpose(0, 1).contiguous()
                                                 .transpose(0, 1), views, gamma, beta)
        with pytest.raises(ValueError, match="f32"):
            siren_kernel.siren_field_fused_parts(pack, pts.double(), views, gamma, beta)
        small = _field_args(torch.float32, width=32)
        with pytest.raises(ValueError, match="widths"):
            siren_kernel.siren_field_fused_parts(*small)


def test_sampler_runs_the_field_kernel(cuda):
    cfg = GeneratorConfig(size=32, style_dim=16, channel_multiplier=1, renderer=RendererConfig(
        out_im_res=16, n_samples=8, style_dim=16, width=64, depth=2))
    model = Generator(cfg, device="cuda", generator=torch.Generator().manual_seed(2))
    fused = SDFaceSampler(model, batch=2)
    plain = SDFaceSampler(model, batch=2, use_fused_kernel=False)
    before = _ext.LAUNCHES["siren_field"]
    a = fused.sample(seed=1)
    assert _ext.LAUNCHES["siren_field"] == before + 1
    b = plain.sample(seed=1)
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=2e-3, atol=2e-4)
    bf16 = SDFaceSampler(copy.deepcopy(model).to(torch.bfloat16), batch=2)
    c = bf16.sample(seed=1)
    assert c.dtype == torch.bfloat16 and bool(torch.isfinite(c).all())
    assert model.cfg.renderer.use_fused_kernel is False  # the model's cfg is untouched
