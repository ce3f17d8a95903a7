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
from sdface_gan_tpu_torch.ops import hash_encoder as hg  # noqa: E402
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


def _device_kernels(fn):
    """Names of the CUDA kernels that ``fn()`` launches, from the profiler
    (three calls, since the profiler can drop some device records)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    return [ev.key for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]


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


@pytest.mark.parametrize("p", [1, 700, 128 * 3 + 5])
@pytest.mark.parametrize("width", [64, 192, 256, 512])
@pytest.mark.parametrize("depth", [1, 3, 8])
def test_bf16_field_kernel_holds_the_bf16_contract(cuda, depth, width, p):
    """The tensor-core kernel: its mean error against the f32 field is no
    worse than the plain bf16 version's (test_ops.py:346-381), over widths
    (tiles of 512, 256, 128, 64 points), depths and ragged last tiles; one
    launch per call."""
    f32 = _field_args(torch.float32, depth=depth, width=width, p=p, seed=depth + width + p)
    pack32, pts, views, gamma32, beta32 = f32
    net16 = _field_args(torch.bfloat16, depth=depth, width=width, p=p, seed=depth + width + p)
    pack16, _, _, gamma16, beta16 = net16
    with torch.no_grad():
        truth = torch.cat([t.float() for t in siren_kernel.siren_field_reference(*f32)], -1)
        plain = siren_kernel.siren_field_reference(pack16, pts, views, gamma16, beta16)
        before = _ext.LAUNCHES["siren_field"]
        got = siren_kernel.siren_field_fused_parts(pack16, pts, views, gamma16, beta16)
        torch.cuda.synchronize()
        assert _ext.LAUNCHES["siren_field"] == before + 1
    for g, w in zip(got, plain):
        assert g.dtype == w.dtype and g.shape == w.shape
    got = torch.cat([t.float() for t in got], -1)
    plain = torch.cat([t.float() for t in plain], -1)
    assert bool(torch.isfinite(got).all())
    err_kernel = (got - truth).abs().mean().item()
    err_plain = (plain - truth).abs().mean().item()
    assert err_kernel <= 1.2 * err_plain + 1e-4, (err_kernel, err_plain)


@pytest.mark.parametrize("p", [1, 700, 128 * 3 + 5])
@pytest.mark.parametrize("width", [64, 192, 256, 512])
@pytest.mark.parametrize("depth", [1, 3, 8])
def test_f32_field_kernel_matches_plain_version(cuda, depth, width, p):
    """The f32 register-blocked kernel against the plain f32 field (only the
    summation order differs), over widths (tiles of 512, 168, 128, 64
    points), depths and ragged last tiles; one launch per call."""
    args = _field_args(torch.float32, depth=depth, width=width, p=p, seed=depth + width + p)
    with torch.no_grad():
        want = siren_kernel.siren_field_reference(*args)
        before = _ext.LAUNCHES["siren_field"]
        got = siren_kernel.siren_field_fused_parts(*args)
        torch.cuda.synchronize()
        assert _ext.LAUNCHES["siren_field"] == before + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        assert (g - w).abs().max().item() <= 1e-3
        assert bool(torch.isfinite(g).all())


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
    # each request through the kernel of its dtype, seen by name on the card
    names16 = _device_kernels(lambda: bf16.sample(seed=1))
    assert any(siren_kernel.kernel_name(torch.bfloat16) in k for k in names16), names16
    assert not any(siren_kernel.kernel_name(torch.float32) in k for k in names16), names16
    names32 = _device_kernels(lambda: fused.sample(seed=1))
    assert any(siren_kernel.kernel_name(torch.float32) in k for k in names32), names32
    assert not any(siren_kernel.kernel_name(torch.bfloat16) in k for k in names32), names32
    assert model.cfg.renderer.use_fused_kernel is False  # the model's cfg is untouched


GRIDS = {
    "tuned": dict(num_levels=4, level_dim=8, desired_resolution=256, log2_hashmap_size=15),
    "upstream": dict(num_levels=16, level_dim=2, desired_resolution=4096,
                     log2_hashmap_size=19),
}


def _grid_inputs(name, n=20000, seed=0, bound=2.0):
    """A std-1 table (a wrong corner row shows as an O(1) error), uniform
    points a little beyond the box, and points on cell faces of every level."""
    spec = hg.HashGridSpec.create(**GRIDS[name])
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((spec.table_size, spec.level_dim)).astype(np.float32)
    x = [rng.uniform(-1.1 * bound, 1.1 * bound, (n, 3))]
    for lvl in range(spec.num_levels):
        scale = spec.level_scale(lvl)
        m = rng.integers(1, int(scale) + 1, (64, 3))
        x.append((m - 0.5) / scale * 2.0 * bound - bound)
    x = np.concatenate(x).astype(np.float32)
    return spec, torch.from_numpy(table).cuda(), torch.from_numpy(x).cuda()


@pytest.mark.parametrize("name", list(GRIDS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_encode_kernel_matches_plain_version(cuda, name, dtype):
    spec, table, x = _grid_inputs(name)
    table = table.to(getattr(torch, dtype))
    with torch.no_grad():
        before = _ext.LAUNCHES["hash_encode"]
        got = hg.hash_encode(x, table, spec, bound=2.0)
        torch.cuda.synchronize()
        assert _ext.LAUNCHES["hash_encode"] == before + 1
        want = hg.hash_encode_reference(x, table, spec, bound=2.0)
        part = hg.hash_encode(x, table, spec, bound=2.0, levels=(1, 3))
    assert got.dtype == want.dtype == table.dtype and got.shape == want.shape
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    if dtype == "float32":  # only the order of the sum over corners differs
        assert np.abs(g - w).max() <= 1e-5
    else:  # one bf16 rounding of sums that differ in their last f32 bits
        assert np.all(np.abs(g - w) <= 8e-3 * np.abs(w) + 1e-6)
    c = spec.level_dim
    cols = np.r_[c:2 * c, 3 * c:4 * c]
    np.testing.assert_array_equal(part.float().cpu().numpy(), g[:, cols])


def _request_points(batch=2, res=64, samples=24, seed=0):
    """A random-camera request's sample points [batch * res^2 * samples, 3]
    in the renderer's order (a ray's samples, then the next ray), normalized
    as ``render`` normalizes them."""
    from sdface_gan_tpu_torch.geometry import generate_camera_params
    from sdface_gan_tpu_torch.geometry.rays import get_rays
    from sdface_gan_tpu_torch.models.renderer import _sample_z_vals

    rcfg = RendererConfig(out_im_res=res, n_samples=samples)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cams = generate_camera_params(res, gen, batch=batch, device="cuda")
    rays = get_rays(cams.focal, cams.extrinsics, res)
    near, far = cams.near.reshape(batch, 1, 1, 1), cams.far.reshape(batch, 1, 1, 1)
    z = _sample_z_vals(rcfg, near, far, batch, gen)
    pts = rays.origins[..., None, :] + rays.directions[..., None, :] * z[..., None]
    return (pts * 2.0 / (far - near)[..., None]).reshape(-1, 3).contiguous()


@pytest.mark.parametrize("name", list(GRIDS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_encode_kernel_on_request_points(cuda, name, dtype):
    """A real request's points, whose coherence the kernel's speed depends
    on and its result must not: every level, and the tuned grid's served
    subset (the levels the packed path leaves to the encode)."""
    spec, table, _ = _grid_inputs(name, n=10)
    table = table.to(getattr(torch, dtype))
    x = _request_points()
    subsets = [None, (2, 3)] if name == "tuned" else [None]
    for levels in subsets:
        with torch.no_grad():
            before = _ext.LAUNCHES["hash_encode"]
            got = hg.hash_encode(x, table, spec, bound=2.0, levels=levels)
            torch.cuda.synchronize()
            assert _ext.LAUNCHES["hash_encode"] == before + 1
            want = hg.hash_encode_reference(x, table, spec, bound=2.0, levels=levels)
        assert got.dtype == want.dtype == table.dtype and got.shape == want.shape
        g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
        if dtype == "float32":
            assert np.abs(g - w).max() <= 1e-5
        else:
            assert np.all(np.abs(g - w) <= 8e-3 * np.abs(w) + 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_table_gather_kernel_is_bit_equal(cuda, dtype):
    rng = np.random.default_rng(1)
    # the probe's shapes: [512, 128] f32 table, [8, 128] int32, one column
    table = torch.arange(512 * 128, dtype=torch.float32).reshape(512, 128).cuda()
    idx = torch.from_numpy(rng.integers(0, 512, (8, 128)).astype(np.int32)).cuda()
    idx[0, 0], idx[-1, -1] = 0, 511
    # packed-row shapes: 64-wide rows, [2, N] indices, and a column slice
    packed = torch.from_numpy(rng.standard_normal((4096, 64)).astype(np.float32)).cuda()
    pidx = torch.from_numpy(rng.integers(0, 4096, (2, 3001)).astype(np.int32)).cuda()
    cases = [(table, idx, 0, 1), (packed, pidx, 0, None), (packed, pidx, 8, 24),
             (packed, pidx, 3, 5), (packed, pidx - 5, 60, 4)]  # ragged, clamped
    with torch.no_grad():
        for t, i, col, ncols in cases:
            t = t.to(getattr(torch, dtype))
            before = _ext.LAUNCHES["table_gather"]
            got = hg.table_gather(t, i, col, ncols)
            torch.cuda.synchronize()
            assert _ext.LAUNCHES["table_gather"] == before + 1
            assert torch.equal(got, hg.table_gather_reference(t, i, col, ncols))


def test_packed_encode_through_both_kernels(cuda):
    spec, table, x = _grid_inputs("tuned", seed=2)
    plan = hg.plan_packing(spec, max_bytes=64 << 20, bytes_per_el=2)
    assert plan.packed_levels == (0, 1)
    with torch.no_grad():
        packed = hg.pack_hash_table(table, plan, dtype=torch.float32)
        before = dict(_ext.LAUNCHES)
        got = hg.hash_encode_packed(x, table, packed, plan, bound=2.0)
        torch.cuda.synchronize()
        want = hg.hash_encode_reference(x, table, spec, bound=2.0)
    assert _ext.LAUNCHES["table_gather"] == before["table_gather"] + 1
    assert _ext.LAUNCHES["hash_encode"] == before["hash_encode"] + 1
    assert (got - want).abs().max().item() <= 1e-5


def test_hash_kernels_reject_what_they_do_not_take(cuda):
    spec, table, x = _grid_inputs("tuned", n=100)
    with torch.no_grad():
        with pytest.raises(ValueError, match="int32"):
            hg.table_gather(table, torch.zeros(4, dtype=torch.int64, device="cuda"))
        with pytest.raises(ValueError, match="f32"):
            hg.hash_encode(x.double(), table, spec, bound=2.0)
        wide = hg.HashGridSpec.create(num_levels=2, level_dim=3, log2_hashmap_size=10)
        with pytest.raises(ValueError, match="C in"):
            hg.hash_encode(x, torch.zeros(wide.table_size, 3, device="cuda"), wide)
        with pytest.raises(ValueError, match="contiguous"):
            hg.hash_encode(x.t().contiguous().t(), table, spec, bound=2.0)


def test_sampler_runs_the_hash_kernels(cuda):
    cfg = GeneratorConfig(size=32, style_dim=32, channel_multiplier=1, renderer=RendererConfig(
        type="ngp", out_im_res=16, n_samples=8, style_dim=32, width=32, ngp_num_levels=4,
        ngp_level_dim=8, ngp_finest_res=64, ngp_log2_hashmap_size=13, ngp_pack_mb=1))
    model = Generator(cfg, device="cuda", generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        table = model.renderer.network.encoder.embeddings
        table.copy_(torch.randn(table.shape, generator=torch.Generator().manual_seed(4)))
    fused = SDFaceSampler(model, batch=2)
    assert model.renderer.network.encoder.packed is not None
    plain = SDFaceSampler(model, batch=2, use_fused_kernel=False)
    before = dict(_ext.LAUNCHES)
    a = fused.sample(seed=1)
    assert _ext.LAUNCHES["hash_encode"] == before["hash_encode"] + 1
    assert _ext.LAUNCHES["table_gather"] == before["table_gather"] + 1
    b = plain.sample(seed=1)
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=2e-3, atol=2e-4)


# ---------------------------------------------------------------------------
# Training: no kernel of its own; on the card it must agree with the CPU
# ---------------------------------------------------------------------------

def _train_case():
    """Small stage-A and stage-B models on the CPU, fixed inputs."""
    from sdface_gan_tpu_torch.geometry import generate_camera_params
    from sdface_gan_tpu_torch.models import (
        StyleDiscConfig,
        StyleDiscriminator,
        VolumeRenderDiscConfig,
        VolumeRenderDiscriminator,
    )

    rkw = dict(type="sdf", out_im_res=8, n_samples=6, style_dim=16, width=32, depth=2)
    cfg_a = GeneratorConfig(size=16, style_dim=16, full_pipeline=False,
                            renderer=RendererConfig(output_features=False, return_sdf=True,
                                                    **rkw))
    cfg_b = GeneratorConfig(size=32, style_dim=16, full_pipeline=True, freeze_renderer=True,
                            channel_multiplier=1, channel_base=32,
                            renderer=RendererConfig(**rkw))
    vcfg = VolumeRenderDiscConfig(in_res=8)
    scfg = StyleDiscConfig(size=32, channel_multiplier=1, channel_base=32)
    seed = torch.Generator().manual_seed
    gen = seed(9)
    return dict(
        cfg_a=cfg_a, cfg_b=cfg_b, vcfg=vcfg, scfg=scfg,
        ga=Generator(cfg_a, "cpu", seed(1)), gb=Generator(cfg_b, "cpu", seed(2)),
        va=VolumeRenderDiscriminator(vcfg, seed(3)), sb=StyleDiscriminator(scfg, seed(4)),
        z=torch.randn((2, 16), generator=gen), z2=torch.randn((2, 16), generator=gen),
        cams=generate_camera_params(8, gen, batch=2, device="cpu"),
        imgs=torch.rand((2, 32, 32, 3), generator=gen) * 2 - 1)


def _loss_and_grads(case, which, device):
    from sdface_gan_tpu_torch.geometry import CameraParams
    from sdface_gan_tpu_torch.training import steps

    hp = steps.TrainHParams(batch=2, style_dim=16)
    cams = CameraParams(*[t.to(device) for t in case["cams"]])
    if which == "stage_a_g":
        g, d = copy.deepcopy(case["ga"]).to(device), copy.deepcopy(case["va"]).to(device)
        loss, _ = steps.stage_a_g_loss(g, d, case["cfg_a"], case["vcfg"], hp,
                                       steps.StepInputs(case["z"].to(device), cams))
        params = list(g.parameters())
    else:
        g, d = copy.deepcopy(case["gb"]).to(device), copy.deepcopy(case["sb"]).to(device)
        inputs = steps.StepInputs(case["z"].to(device), cams, case["z2"].to(device), 3)
        loss, _ = steps.stage_b_d_loss(g, d, case["cfg_b"], case["scfg"], hp,
                                       case["imgs"].to(device), inputs, regularize=True)
        params = list(d.parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.item(), [None if x is None else x.cpu() for x in grads]


@pytest.mark.parametrize("which", ["stage_a_g", "stage_b_d_r1"])
def test_training_step_on_the_card_matches_the_cpu(cuda, which):
    """The stage-A G loss (eikonal double backward) and the stage-B D loss
    with R1 (double backward through the blur's depthwise conv): loss rel
    1e-4, each parameter gradient's difference <= 1e-3 of its norm + 1e-6."""
    case = _train_case()
    with torch.enable_grad():
        lc, gc = _loss_and_grads(case, which, "cuda")
        lh, gh = _loss_and_grads(case, which, "cpu")
    assert abs(lc - lh) <= 1e-4 * abs(lh)
    for a, b in zip(gc, gh):
        if b is None:
            assert a is None
            continue
        assert (a - b).norm() <= 1e-3 * b.norm() + 1e-6


def test_training_render_never_launches_the_field_kernel(cuda):
    """A stage-A G step on the card: the launch count of siren_field stays
    put and no profiler row names it."""
    case = _train_case()
    before = _ext.LAUNCHES["siren_field"]
    with torch.enable_grad():
        names = _device_kernels(lambda: _loss_and_grads(case, "stage_a_g", "cuda"))
    assert names and not any("siren_field" in n for n in names)
    assert _ext.LAUNCHES["siren_field"] == before


# ---------------------------------------------------------------------------
# The encode's backward (K1) and double backward (K2), and NGP training
# ---------------------------------------------------------------------------

GRAD_GRIDS = dict(GRIDS, tiny=dict(num_levels=4, level_dim=2, desired_resolution=64,
                                   log2_hashmap_size=7))
# ||kernel - plain|| / ||plain||: f32 outputs differ in the atomics' and the
# sums' order; a bf16 output by one bf16 rounding of f32 sums
GRAD_RTOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
CONTENTION_N = {"one_cell": 4096, "rays": 24 * 1024}
# the spread points, and points that put a warp's lanes on one row
# (``_contention_points``), on every grid; the spread cases keep their ids
GRAD_POINTS = ["spread", "one_cell", "rays", "mixed_1", "mixed_31", "mixed_33", "mixed_700"]
GRAD_CASES = [pytest.param(name, points, id=name if points == "spread" else f"{name}-{points}")
              for name in GRAD_GRIDS for points in GRAD_POINTS]


def _contention_points(spec, kind, n, rng, bound):
    """Points that put many lanes of a warp on one table row: ``one_cell``
    (every point in one cell of level 0), ``rays`` (24 sorted samples per
    ray, neighbouring rays next to each other, as the renderer orders them)
    and ``mixed`` (in-box, out-of-box, box-face points and one point
    repeated, shuffled; the first point in the box; n not a multiple of 32
    leaves tail lanes)."""
    if kind == "one_cell":
        pos = np.array([2.0, 3.0, 1.0]) + rng.uniform(0.1, 0.9, (n, 3))
        return (pos - 0.5) / spec.level_scale(0) * 2.0 * bound - bound
    if kind == "rays":
        i = np.arange(n // 24)
        side = int(np.sqrt(len(i)))
        d = np.stack([(i % side) / side - 0.5, (i // side) / side - 0.5, np.full(len(i), 2.0)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = np.sort(rng.uniform(0.5, 2.3, (len(i), 24)), axis=-1)
        x = np.array([0.1, -0.2, -1.4 * bound]) + t[..., None] * bound * d[:, None]
        return x.reshape(-1, 3)
    x = rng.uniform(-1.1 * bound, 1.1 * bound, (n, 3))
    kinds, axis = rng.integers(0, 4, n), rng.integers(0, 3, n)
    face = kinds == 1
    x[face, axis[face]] = np.where(rng.integers(0, 2, face.sum()) == 1, bound, -bound)
    x[kinds == 2] = np.array([0.11, -0.52, 0.93]) * bound
    x[0] = np.array([0.3, 0.2, -0.1]) * bound
    return x


def _grad_inputs(name, dtype, n=30000, seed=3, bound=2.0, points="spread"):
    """A std-1 table, g and v; the points: ``spread`` (uniform points a
    little beyond the box, points on cell faces of every level and on the
    faces of the box) or a kind of ``_contention_points`` (``mixed_<n>``: n
    mixed points)."""
    spec, table, x = _grid_inputs(name if name in GRIDS else "tuned", n=n, seed=seed,
                                  bound=bound)
    if name not in GRIDS:
        spec = hg.HashGridSpec.create(**GRAD_GRIDS[name])
        rng = np.random.default_rng(seed)
        table = torch.from_numpy(rng.standard_normal(
            (spec.table_size, spec.level_dim)).astype(np.float32)).cuda()
    rng = np.random.default_rng(seed + 1)
    if points == "spread":
        faces = rng.uniform(-bound, bound, (300, 3))
        faces[np.arange(300), np.arange(300) % 3] = np.where(np.arange(300) % 2, bound, -bound)
        x = torch.cat([x, torch.from_numpy(faces.astype(np.float32)).cuda()]).contiguous()
    else:
        kind, _, count = points.rpartition("_") if points.startswith("mixed_") else (points, "", "")
        pts = _contention_points(spec, kind, int(count) if count else CONTENTION_N[kind], rng,
                                 bound)
        x = torch.from_numpy(pts.astype(np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal((x.shape[0], spec.output_dim)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((x.shape[0], 3)).astype(np.float32))
    return spec, x, table.to(dtype), g.cuda().to(dtype), v.cuda()


def _rel(got, want):
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


@pytest.mark.parametrize("name,points", GRAD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_backward_kernel_matches_plain_version(cuda, name, points, dtype):
    """K1: d x and d table together and each alone, against the plain
    version (sorted segment sum; autograd through the plain encode)."""
    dt = getattr(torch, dtype)
    spec, x, table, g, _ = _grad_inputs(name, dt, points=points)
    before = _ext.LAUNCHES["hash_encode_backward"]
    dx, dtable = hg.hash_encode_backward(x, table, g, spec, 2.0)
    dx_alone, none = hg.hash_encode_backward(x, table, g, spec, 2.0, need_table=False)
    none2, dtable_alone = hg.hash_encode_backward(x, table, g, spec, 2.0, need_x=False)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["hash_encode_backward"] == before + 3
    assert none is None and none2 is None
    want_dx, want_dtable = hg.hash_encode_backward_reference(x, table, g, spec, 2.0)
    assert dx.dtype == torch.float32 and dtable.dtype == dt
    oob = (x.abs() > 2.0).any(-1)
    assert bool(oob.any()) or points != "spread"
    assert bool((dx[oob] == 0).all()) and bool((dx_alone[oob] == 0).all())
    for got in (dx, dx_alone):
        assert _rel(got, want_dx) <= GRAD_RTOL[torch.float32]
    for got in (dtable, dtable_alone):
        assert _rel(got, want_dtable) <= GRAD_RTOL[dt]


@pytest.mark.parametrize("name,points", GRAD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_double_backward_kernel_matches_plain_version(cuda, name, points, dtype):
    """K2: d table and d g of <v, d x> against autograd's double backward
    through the plain encode."""
    dt = getattr(torch, dtype)
    spec, x, table, g, v = _grad_inputs(name, dt, seed=5, points=points)
    before = _ext.LAUNCHES["hash_encode_double_backward"]
    dtable, dg = hg.hash_encode_double_backward(x, table, g, v, spec, 2.0)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["hash_encode_double_backward"] == before + 1
    want_dtable, want_dg = hg.hash_encode_double_backward_reference(x, table, g, v, spec, 2.0)
    assert dtable.dtype == dg.dtype == dt and dg.shape == g.shape
    assert _rel(dtable, want_dtable) <= GRAD_RTOL[dt]
    assert _rel(dg, want_dg) <= GRAD_RTOL[dt]
    assert bool((dg[(x.abs() > 2.0).any(-1)] == 0).all())


@pytest.mark.parametrize("name,points", GRAD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_double_backward_kernel_in_its_jvp_roles(cuda, name, points, dtype):
    """K2 as the forward-mode eikonal runs it: d g alone with no g (the
    encode's tangent along v, counted as ``hash_encode_jvp``) and d table
    alone (the tangent's table gradient), against the plain version."""
    dt = getattr(torch, dtype)
    spec, x, table, g, v = _grad_inputs(name, dt, seed=6, points=points)
    before = dict(_ext.LAUNCHES)
    _, jvp = hg.hash_encode_double_backward(x, table, None, v, spec, 2.0, need_table=False)
    dtable, _ = hg.hash_encode_double_backward(x, table, g, v, spec, 2.0, need_g=False)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["hash_encode_jvp"] == before["hash_encode_jvp"] + 1
    assert (_ext.LAUNCHES["hash_encode_double_backward"]
            == before["hash_encode_double_backward"] + 1)
    want_dtable, want_dg = hg.hash_encode_double_backward_reference(x, table, g, v, spec, 2.0)
    assert jvp.dtype == dtable.dtype == dt and jvp.shape == g.shape
    assert _rel(jvp, want_dg) <= GRAD_RTOL[dt]
    assert _rel(dtable, want_dtable) <= GRAD_RTOL[dt]
    assert bool((jvp[(x.abs() > 2.0).any(-1)] == 0).all())


def test_encode_forward_mode_on_the_card_matches_the_cpu(cuda):
    """``hash_encode`` under forward AD on the card (``_HashEncode.jvp``):
    the tangent and the table gradient of a loss on it, against forward AD
    through the plain encode on the CPU; K2 launches in both roles."""
    import torch.autograd.forward_ad as fwAD

    spec, x, table, g, v = _grad_inputs("tuned", torch.float32, n=5000, seed=8)

    def run(device):
        tt = table.to(device).requires_grad_()
        with fwAD.dual_level():
            out = hg.hash_encode(fwAD.make_dual(x.to(device), v.to(device)), tt, spec, bound=2.0)
            tangent = fwAD.unpack_dual(out).tangent
        (dtable,) = torch.autograd.grad(torch.sum(tangent * g.to(device)), tt)
        return tangent.cpu(), dtable.cpu()

    before = dict(_ext.LAUNCHES)
    card = run("cuda")
    assert _ext.LAUNCHES["hash_encode_jvp"] == before["hash_encode_jvp"] + 1
    assert (_ext.LAUNCHES["hash_encode_double_backward"]
            == before["hash_encode_double_backward"] + 1)
    for got, want in zip(card, run("cpu")):
        assert _rel(got, want) <= 1e-5


def test_encode_autograd_on_the_card_matches_the_cpu(cuda):
    """``hash_encode`` under autograd on the card: first-order gradients and
    the eikonal-style second-order table and cotangent gradients, against
    the CPU's autograd through the plain encode; K1 and K2 launch."""
    spec, x, table, g, _ = _grad_inputs("tuned", torch.float32, n=5000, seed=7)

    def run(device):
        xt = x.to(device).requires_grad_()
        tt = table.to(device).requires_grad_()
        a = g.to(device).requires_grad_()
        out = hg.hash_encode(xt, tt, spec, bound=2.0)
        (dx,) = torch.autograd.grad(torch.sum(out * a), xt, create_graph=True)
        loss = torch.sum(out * a) + torch.sum(dx ** 2)
        return [t.cpu() for t in torch.autograd.grad(loss, (tt, a))]

    before = dict(_ext.LAUNCHES)
    card = run("cuda")
    assert _ext.LAUNCHES["hash_encode_backward"] > before["hash_encode_backward"]
    assert (_ext.LAUNCHES["hash_encode_double_backward"]
            == before["hash_encode_double_backward"] + 1)
    for got, want in zip(card, run("cpu")):
        assert _rel(got, want) <= 1e-5


def _ngp_train_case():
    from sdface_gan_tpu_torch.geometry import generate_camera_params
    from sdface_gan_tpu_torch.models import VolumeRenderDiscConfig, VolumeRenderDiscriminator

    rkw = dict(type="ngp", out_im_res=8, n_samples=6, style_dim=16, width=16, ngp_num_levels=4,
               ngp_level_dim=8, ngp_finest_res=64, ngp_log2_hashmap_size=12,
               output_features=False, return_sdf=True)
    cfg = GeneratorConfig(size=16, style_dim=16, full_pipeline=False,
                          renderer=RendererConfig(**rkw))
    seed = torch.Generator().manual_seed
    g = Generator(cfg, "cpu", seed(1))
    with torch.no_grad():
        emb = g.renderer.network.encoder.embeddings
        emb.copy_(0.3 * torch.randn(emb.shape, generator=seed(2)))
    gen = seed(9)
    vcfg = VolumeRenderDiscConfig(in_res=8)
    return dict(cfg=cfg, vcfg=vcfg, g=g, d=VolumeRenderDiscriminator(vcfg, seed(3)),
                z=torch.randn((2, 16), generator=gen),
                cams=generate_camera_params(8, gen, batch=2, device="cpu"),
                smooth=(torch.rand(3, generator=gen), torch.rand(3, generator=gen)))


@pytest.mark.parametrize("remat", [True, False])
def test_ngp_stage_a_step_on_the_card_launches_the_kernels(cuda, monkeypatch, remat):
    """The NGP stage-A G loss (full eikonal, smoothness) on the card: the
    forward, K1 and K2 launch, the plain encode is never called on a CUDA
    tensor, and the loss and every gradient agree with the CPU (loss rel
    1e-4, each gradient within 1e-3 of its norm + 1e-6)."""
    from dataclasses import replace

    from sdface_gan_tpu_torch.geometry import CameraParams
    from sdface_gan_tpu_torch.models import siren
    from sdface_gan_tpu_torch.training import steps

    case = _ngp_train_case()
    cfg = replace(case["cfg"], renderer=replace(case["cfg"].renderer, remat=remat))
    plain_on_card = []
    for module in (hg, siren):
        original = module.hash_encode_reference

        def counted(x, *args, _original=original, **kw):
            if x.is_cuda:
                plain_on_card.append(tuple(x.shape))
            return _original(x, *args, **kw)

        monkeypatch.setattr(module, "hash_encode_reference", counted)

    def run(device):
        g, d = copy.deepcopy(case["g"]).to(device), copy.deepcopy(case["d"]).to(device)
        inputs = steps.StepInputs(case["z"].to(device),
                                  CameraParams(*[t.to(device) for t in case["cams"]]),
                                  smooth_draws=tuple(t.to(device) for t in case["smooth"]))
        loss, m = steps.stage_a_g_loss(g, d, cfg, case["vcfg"],
                                       steps.TrainHParams(batch=2, style_dim=16), inputs)
        grads = torch.autograd.grad(loss, list(g.parameters()), allow_unused=True)
        return loss.item(), m, [None if t is None else t.cpu() for t in grads]

    with torch.enable_grad():
        _ext.reset_launch_counts()
        lc, mc, gc = run("cuda")
        launches = dict(_ext.LAUNCHES)
        lh, _, gh = run("cpu")
    for name in ("hash_encode", "hash_encode_backward", "hash_encode_double_backward"):
        assert launches[name] > 0, launches
    assert not plain_on_card
    assert all(bool(torch.isfinite(v)) for v in mc.values()) and mc["g_smooth"] > 0
    assert abs(lc - lh) <= 1e-4 * abs(lh)
    for a, b in zip(gc, gh):
        if b is None:
            assert a is None
            continue
        assert (a - b).norm() <= 1e-3 * b.norm() + 1e-6


def test_ngp_stage_c_e_step_on_the_card(cuda):
    """One VAE E step against a frozen NGP generator on the card: the
    encode's forward launches and neither of its gradient kernels (the
    frozen renderer runs without autograd), the generator takes no gradient,
    and the loss and every encoder gradient agree with the CPU (loss rel
    1e-4, each gradient within 1e-3 of its norm + 1e-6)."""
    from sdface_gan_tpu_torch.encoder import LossUtils, VAEEncoder, VAEEncoderConfig
    from sdface_gan_tpu_torch.geometry import CameraParams, generate_camera_params
    from sdface_gan_tpu_torch.training.encoder_loop import EncoderInputs, encoder_loss

    rkw = dict(type="ngp", out_im_res=8, n_samples=6, style_dim=16, width=16, ngp_num_levels=4,
               ngp_level_dim=8, ngp_finest_res=64, ngp_log2_hashmap_size=12)
    cfg = GeneratorConfig(size=16, style_dim=16, full_pipeline=True, freeze_renderer=True,
                          channel_multiplier=1, renderer=RendererConfig(**rkw))
    seed = torch.Generator().manual_seed
    g = Generator(cfg, "cpu", seed(1)).requires_grad_(False)
    e = VAEEncoder(VAEEncoderConfig(img_size=16, z_size=16), seed(2))
    gen = seed(3)
    data = (torch.rand((2, 16, 16, 3), generator=gen) * 2 - 1,
            torch.rand((2, 8, 8, 3), generator=gen) * 2 - 1, torch.randn((2, 16), generator=gen))
    cams = generate_camera_params(8, gen, batch=2, device="cpu")

    def run(device):
        gd, ed = copy.deepcopy(g).to(device), copy.deepcopy(e).to(device)
        imgs, thumbs, eps = (t.to(device) for t in data)
        inputs = EncoderInputs(imgs, thumbs, CameraParams(*[t.to(device) for t in cams]), eps)
        loss, _ = encoder_loss(ed, gd, cfg, ed.cfg, LossUtils(), inputs)
        grads = torch.autograd.grad(loss, list(ed.parameters()))
        assert all(p.grad is None for p in gd.parameters())
        return loss.item(), [t.cpu() for t in grads]

    with torch.enable_grad():
        _ext.reset_launch_counts()
        lc, gc = run("cuda")
        launches = dict(_ext.LAUNCHES)
        lh, gh = run("cpu")
    assert launches["hash_encode"] > 0, launches
    assert launches["hash_encode_backward"] == launches["hash_encode_double_backward"] == 0
    assert abs(lc - lh) <= 1e-4 * abs(lh)
    for a, b in zip(gc, gh):
        assert (a - b).norm() <= 1e-3 * b.norm() + 1e-6


# ---------------------------------------------------------------------------
# Evaluation and geometry: the surface probe's field shape, the Inception,
# frustum alignment, and the eval entry's launches
# ---------------------------------------------------------------------------

def test_f32_field_kernel_at_the_surface_probe_shape(cuda):
    """sdf_mesh's surface probe: one call at B = 1, P = 128^3, full width."""
    args = _field_args(torch.float32, depth=8, width=256, style_dim=256, p=128 ** 3, seed=5)
    args = (args[0], args[1][:1].contiguous(), args[2][:1].contiguous(),
            args[3][:1].contiguous(), args[4][:1].contiguous())
    with torch.no_grad():
        got = siren_kernel.siren_field_fused_parts(*args)
        want = siren_kernel.siren_field_reference(*args)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert (g.float() - w.float()).abs().max().item() <= 1e-3


@pytest.mark.parametrize("size", [256, 512])
def test_inception_on_the_card_matches_the_cpu(cuda, size):
    from sdface_gan_tpu_torch.evaluation import load_inception

    x = torch.from_numpy(np.random.default_rng(size).uniform(
        -1, 1, (4, size, size, 3)).astype(np.float32))
    with torch.no_grad():
        want = load_inception(device="cpu")(x)
        got = load_inception(device="cuda")(x.cuda()).cpu()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_align_volume_on_the_card_matches_the_cpu(cuda):
    from sdface_gan_tpu_torch.geometry.mesh import align_volume

    lin = torch.linspace(-1, 1, 48)
    y, x, z = torch.meshgrid(lin, lin, torch.linspace(-1, 1, 40), indexing="ij")
    vol = (torch.sqrt((x / 0.7) ** 2 + (y / 0.8) ** 2 + (z / 0.6) ** 2) - 0.8
           + 0.05 * torch.sin(3 * x + 2 * y))[None, ..., None]
    want = align_volume(vol)
    got = align_volume(vol.cuda()).cpu()
    assert torch.equal(got == 1.0, want == 1.0)
    assert (got - want).abs().max() <= 1e-6


EVAL_YAML = """inherit_from: configs/256res/ffhq_256_sdf.yaml
training:
  out_dir: out/{exp}
data:
  img_size: 32
rendering:
  width: 64
  depth: 2
  N_samples: 8
{extra}train_args:
  renderer_spatial_output_dim: 16
  size: 32
  style_dim: 64
  channel_multiplier: 1
"""
NGP_EXTRA = """  type: ngp
  num_levels: 4
  level_dim: 8
  finest_res: 64
  log2_hashmap_size: 13
  pack_mb: 1
"""


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "ngp"])
def test_eval_runs_the_kernels_of_its_path(cuda, tmp_path, monkeypatch, kind):
    """``python -m sdface_gan_tpu_torch.eval`` on a small random checkpoint:
    the f32 or bf16 field kernel (seen by name), or the hash kernels; the
    plain field and the plain encode never run on a CUDA tensor."""
    import os

    from sdface_gan_tpu_torch import eval as eval_cli
    from sdface_gan_tpu_torch.config import load_config
    from sdface_gan_tpu_torch.config.build import generator_config, stage_options
    from sdface_gan_tpu_torch.models import siren
    from sdface_gan_tpu_torch.utils.checkpoints import save_checkpoint

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.symlink(os.path.join(repo, "configs"), tmp_path / "configs")
    (tmp_path / "e.yaml").write_text(EVAL_YAML.format(
        exp="e", extra=NGP_EXTRA if kind == "ngp" else ""))
    monkeypatch.chdir(tmp_path)
    gcfg = generator_config(stage_options(load_config("e.yaml"), False), stage_a=False)
    g = Generator(gcfg, device="cpu", generator=torch.Generator().manual_seed(6))
    save_checkpoint("out/e", "full_pipeline", {"g_ema": g.state_dict()})

    plain = []
    for module, name in ((siren_kernel, "siren_field_reference"),
                         (hg, "hash_encode_reference"), (siren, "hash_encode_reference")):
        def counted(x, *a, _original=getattr(module, name), **kw):
            if x.is_cuda:
                plain.append(name)
            return _original(x, *a, **kw)

        monkeypatch.setattr(module, name, counted)
    monkeypatch.setattr(siren.SirenGenerator, "forward_parts",
                        lambda self, pts, *a: plain.append("SirenGenerator") or None)
    args = ["--config", "e.yaml", "--n_images", "4", "--batch", "2", "--no_dump", "--no_fid"]
    if kind == "bfloat16":
        args += ["--g_dtype", "bfloat16"]
    _ext.reset_launch_counts()
    stats = eval_cli.main(args)
    launches = dict(_ext.LAUNCHES)
    assert stats["n_images"] == 4 and not plain, plain
    if kind == "ngp":
        assert launches["hash_encode"] == 2 and launches["table_gather"] == 2, launches
        return
    assert launches["siren_field"] == 2, launches
    names = _device_kernels(lambda: eval_cli.main(args))
    dtype = getattr(torch, kind)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    assert any(siren_kernel.kernel_name(dtype) in k for k in names), names
    assert not any(siren_kernel.kernel_name(other) in k for k in names), names


def test_bench_forward_runs_the_bf16_field_kernel(cuda):
    """``bench``'s timed call (``SDFaceSampler.sample``) at full width, batch
    2: one ``siren_field_mma_kernel`` launch per call, by count and by name,
    and a finite 256^2 image."""
    from sdface_gan_tpu_torch import bench

    record = bench.run_bench(bench.flagship_config(), 2, warmup=1, iters=2)
    assert record["launches"]["siren_field"] == 2 and record["finite"]
    assert record["shape"] == [2, 256, 256, 3] and len(record["iter_ms"]) == 2
    sampler = SDFaceSampler(bench.serving_model(bench.flagship_config(), "cuda"), batch=2,
                            truncation=bench.TRUNCATION)
    names = _device_kernels(lambda: sampler.sample(seed=1))
    assert any(siren_kernel.kernel_name(torch.bfloat16) + "<256>" in k for k in names), names


def test_sampler_at_512_runs_the_field_kernel_and_matches_the_cpu(cuda):
    """The 512^2 configuration's pyramid (``configs/512res/ffhq_512_sdf_tpu.yaml``:
    the renderer at 64^2, three decoder doublings) at a width cut (field 64
    x 2, 8 samples, style 64, ``channel_base`` 16): an f32 request through
    the f32 field kernel on the card (one launch) within 2e-3 of the same
    request on the CPU (the plain field), fixed z and viewpoint, no depth
    jitter; a bf16 request runs ``siren_field_mma_kernel<64>`` by name."""
    from dataclasses import replace

    from sdface_gan_tpu_torch.bench_serving_512 import config_512

    full = config_512()
    cfg = replace(full, style_dim=64, channel_base=16, renderer=replace(
        full.renderer, width=64, depth=2, n_samples=8, style_dim=64, perturb=0.0))
    model = Generator(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    card = SDFaceSampler(copy.deepcopy(model).cuda(), batch=2, truncation=1.0)
    cpu = SDFaceSampler(model, batch=2, truncation=1.0)
    z = np.random.default_rng(6).standard_normal((2, 64)).astype(np.float32)
    before = _ext.LAUNCHES["siren_field"]
    got = card.sample(z=z, azim=0.2, elev=-0.1)
    torch.cuda.synchronize()
    assert _ext.LAUNCHES["siren_field"] == before + 1
    want = cpu.sample(z=z, azim=0.2, elev=-0.1)
    assert tuple(got.shape) == (2, 512, 512, 3)
    err = (got.cpu() - want).abs().max().item()
    assert err <= 2e-3, err
    bf16 = SDFaceSampler(copy.deepcopy(model).cuda().to(torch.bfloat16), batch=2, truncation=1.0)
    assert bool(torch.isfinite(bf16.sample(z=z, azim=0.2, elev=-0.1)).all())
    names = _device_kernels(lambda: bf16.sample(seed=1))
    assert any(siren_kernel.kernel_name(torch.bfloat16) + "<64>" in k for k in names), names
    assert not any(siren_kernel.kernel_name(torch.float32) in k for k in names), names


@pytest.mark.parametrize("grid", ["upstream", "tuned"])
def test_bench_ngp_hash_functions_match_their_plain_versions(cuda, grid):
    """The forward and table gradient ``bench_hash_fwd_bwd`` times, through
    ``hash_encode`` and K1 on the card, against the same functions on the
    CPU (plain versions), std-1 table."""
    from sdface_gan_tpu_torch import bench_ngp

    kw = (dict(desired_resolution=4096) if grid == "upstream" else
          dict(num_levels=4, level_dim=8, desired_resolution=256, log2_hashmap_size=15))
    spec = hg.HashGridSpec.create(**kw)
    x, table = bench_ngp.hash_inputs(spec, 1 << 15, "cuda", seed=3, std=1.0)
    card = bench_ngp.hash_functions(x, table, spec)
    cpu = bench_ngp.hash_functions(x.cpu(), table.cpu(), spec)
    before = dict(_ext.LAUNCHES)
    fwd, grad = card["forward"](), card["table_grad"]()
    assert _ext.LAUNCHES["hash_encode"] - before["hash_encode"] == 2
    assert _ext.LAUNCHES["hash_encode_backward"] - before["hash_encode_backward"] == 1
    torch.testing.assert_close(fwd.cpu(), cpu["forward"](), rtol=0, atol=1e-5)
    want = cpu["table_grad"]()
    assert (grad.cpu() - want).norm() <= 1e-5 * want.norm()


def test_jax_fixture_serves_on_the_card_as_jax_rendered_it(cuda, tmp_path):
    """The committed JAX run (``tests/fixtures/jax_run/``): its stage-B
    archives imported, its ``full_pipeline`` served through
    ``from_checkpoint`` and the f32 field kernel with JAX's z, camera angles
    and truncation pair, within 2e-3 (the card against the CPU) plus
    ``IMAGE_TOL`` (rtol 2e-3, atol 2e-4: the CPU against JAX) of JAX's
    images."""
    import os
    from dataclasses import replace

    from sdface_gan_tpu_torch.config import load_config
    from sdface_gan_tpu_torch.config.yaml_config import default_config_path
    from sdface_gan_tpu_torch.train import stage_configs
    from sdface_gan_tpu_torch.utils.checkpoints import RunConfigs, import_jax_run

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "jax_run")
    with np.load(os.path.join(fixture, "samples.npz")) as f:
        s = {k: f[k] for k in f.files}
    gcfg, sd, hp = stage_configs(load_config(os.path.join(fixture, "jax_bridge.yaml"),
                                             default_config_path()), False)
    gcfg, sd = replace(gcfg, channel_base=int(s["channel_base"])), \
        replace(sd, channel_base=int(s["channel_base"]))
    import_jax_run(os.path.join(fixture, "stage_b"), str(tmp_path),
                   RunConfigs(stage_a=None, stage_b=(gcfg, sd, hp), vae=None, psp=None))
    before = _ext.LAUNCHES["siren_field"]
    sampler = SDFaceSampler.from_checkpoint(
        str(tmp_path), cfg=replace(gcfg, renderer=replace(gcfg.renderer, perturb=0.0)),
        batch=len(s["z"]), truncation=float(s["truncation"]),
        truncation_latent=tuple(torch.from_numpy(s[k]).cuda()
                                for k in ("trunc_renderer", "trunc_decoder")))
    img = sampler.sample(z=s["z"], azim=float(s["azim"]), elev=float(s["elev"])).cpu().numpy()
    assert _ext.LAUNCHES["siren_field"] > before
    np.testing.assert_allclose(img, s["images"], rtol=2e-3, atol=2e-4 + 2e-3)


def test_jax_giraffe_fixture_serves_on_the_card_as_jax_rendered_it(cuda, tmp_path):
    """The committed JAX GIRAFFE run (``tests/fixtures/jax_giraffe_run/``,
    trained with ``--i_embed 1``): its ``model`` imported, its ``g_ema``
    renders JAX's codes, camera, transforms and background rotation on the
    card through the hash kernel, within 2e-3 (the card against the CPU)
    plus ``IMAGE_TOL`` (rtol 2e-3, atol 2e-4: the CPU against JAX) of JAX's
    images."""
    import os
    import types

    from sdface_gan_tpu_torch.config import load_config
    from sdface_gan_tpu_torch.config.yaml_config import default_config_path
    from sdface_gan_tpu_torch.giraffe.generator import (
        GiraffeGenerator,
        LatentCodes,
        giraffe_forward,
    )
    from sdface_gan_tpu_torch.giraffe.train_loop import giraffe_run_configs
    from sdface_gan_tpu_torch.utils.checkpoints import CheckpointIO, import_jax_run

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                           "jax_giraffe_run")
    configs = giraffe_run_configs(
        load_config(os.path.join(fixture, "jax_giraffe.yaml"), default_config_path()),
        types.SimpleNamespace(i_embed=1, log2_hashmap_size=10, finest_res=64))
    gcfg = configs.generator
    import_jax_run(os.path.join(fixture, "run"), str(tmp_path), configs)
    g = GiraffeGenerator(gcfg)
    g.load_state_dict(CheckpointIO(str(tmp_path)).load("model")["g_ema"])
    g = g.cuda().eval()
    with np.load(os.path.join(fixture, "samples.npz")) as f:
        s = {k: torch.from_numpy(f[k]).cuda() for k in f.files}
    before = _ext.LAUNCHES["hash_encode"]
    with torch.no_grad():
        img = giraffe_forward(g, gcfg, latent_codes=LatentCodes(
            s["z_shape_obj"], s["z_app_obj"], s["z_shape_bg"], s["z_app_bg"]),
            camera_matrices=(s["camera_mat"], s["world_mat"]),
            transformations=(s["s"], s["t"], s["r"]), bg_rotation=s["bg_rotation"],
            mode="eval")
    assert _ext.LAUNCHES["hash_encode"] > before
    np.testing.assert_allclose(img.cpu().numpy(), s["images"].cpu().numpy(), rtol=2e-3,
                               atol=2e-4 + 2e-3)
    # box-local points / 15 outside [-1, 1]^3 encode to zeros through the kernel
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.uniform(-1, 1, (4096, 3)) * 30.0 / 15.0).astype(np.float32)).cuda()
    code = hg.hash_encode(x, g.decoder.hash_table.detach(), gcfg.decoder.hash_spec, 1.0)
    oob = (x.abs() > 1.0).any(-1)
    assert bool(oob.any()) and bool((code[oob] == 0).all())
    want = hg.hash_encode_reference(x, g.decoder.hash_table.detach(), gcfg.decoder.hash_spec, 1.0)
    assert (code - want).abs().max().item() <= 1e-5


# ---------------------------------------------------------------------------
# GIRAFFE's training: K1 on the hash decoders' box-local points, the steps on
# the card against the CPU, K1 in G steps only
# ---------------------------------------------------------------------------

def test_giraffe_k1_on_box_local_points_matches_plain_vjp(cuda):
    """K1 asked for the table gradient alone (the G step's points need no
    d x) on the upstream GIRAFFE grid (16 x 2, T = 2^19), bound 1, at
    box-local points / 15 of which most lie outside the box, a std-1 table:
    within 1e-5 of the plain VJP's norm."""
    from sdface_gan_tpu_torch.giraffe.decoder import giraffe_hash_spec

    spec = giraffe_hash_spec()
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.uniform(-1.0, 1.0, (1 << 17, 3)) * 2.2).astype(np.float32)).cuda()
    oob = (x.abs() > 1.0).any(-1).float().mean().item()
    assert 0.5 < oob < 0.95
    gen = torch.Generator(device="cuda").manual_seed(4)
    table = torch.randn((spec.table_size, spec.level_dim), generator=gen, device="cuda")
    g = torch.randn((x.shape[0], spec.output_dim), generator=gen, device="cuda")
    before = _ext.LAUNCHES["hash_encode_backward"]
    dx, got = hg.hash_encode_backward(x, table, g, spec, 1.0, need_x=False, need_table=True)
    assert dx is None and _ext.LAUNCHES["hash_encode_backward"] == before + 1
    _, want = hg.hash_encode_backward_reference(x, table, g, spec, 1.0, need_x=False,
                                                need_table=True)
    assert (got - want).norm().item() <= GRAD_RTOL[torch.float32] * want.norm().item()


def _giraffe_fixture_models():
    """The committed fixture's configs (hash decoder, T = 2^10; 16 samples per
    ray, batch 2) and G (table redrawn at std 1), D and VAE on the CPU, as
    the train entry builds them from seed 1."""
    import dataclasses
    import os
    import types

    from sdface_gan_tpu_torch.config import load_config
    from sdface_gan_tpu_torch.config.yaml_config import default_config_path
    from sdface_gan_tpu_torch.giraffe.train_loop import giraffe_models, giraffe_run_configs

    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                           "jax_giraffe_run")
    configs = giraffe_run_configs(
        load_config(os.path.join(fixture, "jax_giraffe.yaml"), default_config_path()),
        types.SimpleNamespace(i_embed=1, log2_hashmap_size=10, finest_res=64))
    configs = configs._replace(generator=dataclasses.replace(configs.generator,
                                                             n_ray_samples=16))
    g, d, _, _, _, e, _ = giraffe_models(configs, torch.Generator().manual_seed(1), "cpu", True)
    with torch.no_grad():
        g.decoder.hash_table.normal_(generator=torch.Generator().manual_seed(2))
    return configs, g, d, e


def test_giraffe_steps_on_the_card_match_the_cpu(cuda):
    """One D, one G and one VAE E step of GIRAFFE's trainer on the same
    weights and draws: the card against the CPU (loss rel 1e-4, every
    gradient within 1e-3 of its norm + 1e-6), each step's gradients over its
    own module only; on the card K1 runs in the G step alone (the table's
    gradient, the hash table being a G parameter), and in neither the D
    step (its fakes rendered without a graph) nor the E step."""
    from sdface_gan_tpu_torch.giraffe import trainer as tr

    configs, g, d, e = _giraffe_fixture_models()
    gcfg, hp = configs.generator, configs.hp
    gen = torch.Generator().manual_seed(5)
    reals = torch.rand((2, 32, 32, 3), generator=gen)

    def run(kind, dev):
        gd, dd, ed = (copy.deepcopy(m).to(dev) for m in (g, d, e))
        # the same draws on either device: made on the host, mapped on dev
        gen = torch.Generator().manual_seed(6)
        scene = tr.sample_scene_draws(gen, gcfg, 2, dev)
        enc = tr.sample_encoder_draws(gen, gcfg, 2, dev)
        if kind == "d":
            loss, _ = tr.giraffe_d_loss(gd, dd, gcfg, hp, reals.to(dev), scene)
            own = dd
        elif kind == "g":
            with tr.frozen(dd):
                loss, _ = tr.giraffe_g_loss(gd, dd, gcfg, scene)
            own = gd
        else:
            with tr.frozen(gd, dd):
                loss, _ = tr.giraffe_e_loss(ed, gd, dd, gcfg, reals.to(dev), enc)
            own = ed
        grads = torch.autograd.grad(loss, list(own.parameters()))
        assert all(p.grad is None for m in (gd, dd, ed) for p in m.parameters())
        return loss.item(), [t.cpu() for t in grads]

    with torch.enable_grad():
        for kind in ("d", "g", "e"):
            _ext.reset_launch_counts()
            lc, gc = run(kind, "cuda")
            torch.cuda.synchronize()
            launches = dict(_ext.LAUNCHES)
            lh, gh = run(kind, "cpu")
            assert launches["hash_encode"] > 0, (kind, launches)
            assert (launches["hash_encode_backward"] > 0) == (kind == "g"), (kind, launches)
            assert launches["hash_encode_double_backward"] == 0
            assert abs(lc - lh) <= 1e-4 * abs(lh), (kind, lc, lh)
            for a, b in zip(gc, gh):
                assert (a - b).norm() <= 1e-3 * b.norm() + 1e-6, kind


# ---------------------------------------------------------------------------
# Data parallelism: two gloo ranks sharing cuda:0 (NCCL needs a card per rank)
# ---------------------------------------------------------------------------

def _ddp_stage_b():
    from sdface_gan_tpu_torch.geometry import generate_camera_params
    from sdface_gan_tpu_torch.models.discriminator import StyleDiscConfig
    from sdface_gan_tpu_torch.training.steps import StepInputs, TrainHParams

    rcfg = RendererConfig(type="sdf", out_im_res=8, n_samples=4, style_dim=16, width=64,
                          depth=2)  # the CUDA field takes widths 64..512
    gcfg = GeneratorConfig(size=32, style_dim=16, full_pipeline=True, freeze_renderer=True,
                           channel_multiplier=1, channel_base=32, renderer=rcfg)
    gen = torch.Generator().manual_seed(3)
    cams = generate_camera_params(8, gen, batch=8, device="cpu")
    z = torch.randn((8, 16), generator=gen)
    case = dict(kind="b_d", gcfg=gcfg, hp=TrainHParams(batch=8, style_dim=16),
                dcfg=StyleDiscConfig(size=32, channel_multiplier=1, channel_base=16),
                g=1, d=2, gen_seed=4, inputs=StepInputs(z, cams, z.flip(0), 3),
                real=torch.rand((8, 32, 32, 3), generator=gen) * 2 - 1)
    return gcfg, case


def test_two_gloo_ranks_on_the_card_match_one_rank(cuda):
    """A stage-B D step with R1 (the minibatch stddev gathered over the
    ranks, a live generator's draws made for the whole batch) over two gloo
    ranks on cuda:0, against the same step as one rank at global batch 8
    (loss rel 1e-4, gradients 1e-3 of their norm, train_parity's bars), the
    parameters bit-equal across the ranks; and the bf16 sampler at batch 8:
    the gathered images within 2e-3 of one rank's, through the field kernel."""
    import torch_parallel_ranks as ranks

    gcfg, case = _ddp_stage_b()
    payload = dict(device="cuda:0", cases={"b_d": case},
                   samplers=[dict(gcfg=gcfg, g=1, batch=8, dtype="bfloat16",
                                  sample=dict(seed=5), profile=True)])
    res = [ranks._cpu(r) for r in ranks.spawn("cases", 2, payload)]
    served = ranks.spawn("serving", 2, payload)
    one = ranks.run_cases(None, payload)["b_d"]
    two = [r["b_d"] for r in res]
    assert all(torch.equal(two[1]["params"][k], two[0]["params"][k]) for k in two[0]["params"])
    for k, v in one["metrics"].items():
        got = (two[0]["metrics"][k] + two[1]["metrics"][k]) / 2
        assert abs(got - v) <= 1e-4 * abs(v) + 1e-7, (k, got, v)
    for k, g in one["grads"].items():
        assert (two[0]["grads"][k] - g).norm() <= 1e-3 * g.norm() + 1e-7, k
    model = Generator(gcfg, device="cuda", generator=torch.Generator().manual_seed(1))
    images = SDFaceSampler(model.to(torch.bfloat16), batch=8).sample(seed=5).float().cpu()
    assert (served[0]["images0"] - images).abs().max().item() <= 2e-3
    assert torch.equal(served[0]["images0"], served[1]["images0"])
    assert any(siren_kernel.kernel_name(torch.bfloat16) in k for k in served[0]["kernels"])
