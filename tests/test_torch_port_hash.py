"""The port's hash-grid ops (``ops/hash_encoder.py``, ``ops/sh_encoder.py``)
against the JAX package.

Inputs come from ``np.random.default_rng`` and go to both packages.  On the
CPU every wrapper runs its plain version; the CUDA kernels are held against
those plain versions in ``test_torch_port_cuda.py``, which imports no JAX.
Grids: the two yaml grids of ``configs/256res`` and two small ones with
both dense and hashed levels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sdface_gan_tpu.ops import hash_encoder as jh  # noqa: E402
from sdface_gan_tpu.ops.sh_encoder import sh_encode as j_sh_encode  # noqa: E402
from sdface_gan_tpu_torch.ops import _ext  # noqa: E402
from sdface_gan_tpu_torch.ops import hash_encoder as ph  # noqa: E402
from sdface_gan_tpu_torch.ops.sh_encoder import sh_encode  # noqa: E402

GRIDS = {
    "tuned": dict(num_levels=4, level_dim=8, desired_resolution=256, log2_hashmap_size=15),
    "upstream": dict(num_levels=16, level_dim=2, desired_resolution=4096,
                     log2_hashmap_size=19),
    "small": dict(num_levels=4, level_dim=2, base_resolution=4, desired_resolution=64,
                  log2_hashmap_size=7),
    "small_wide": dict(num_levels=3, level_dim=4, base_resolution=4, desired_resolution=64,
                       log2_hashmap_size=8),
}
F32_TOL = dict(rtol=1e-5, atol=1e-6)


def _specs(name):
    return jh.HashGridSpec.create(**GRIDS[name]), ph.HashGridSpec.create(**GRIDS[name])


def _table(spec, seed=0, std=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((spec.table_size, spec.level_dim)) * std).astype(np.float32)


def _points(spec, n, bound, seed=1):
    """Uniform points a little beyond the box (some out of bounds), plus
    points on cell faces of every level (pos = x01 * scale + 0.5 integral)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.2 * bound, 1.2 * bound, (n, 3)).astype(np.float32)
    faces = []
    for lvl in range(spec.num_levels):
        scale = spec.level_scale(lvl)
        m = rng.integers(1, int(scale) + 1, (8, 3))
        faces.append(((m - 0.5) / scale * 2.0 * bound - bound).astype(np.float32))
    return np.concatenate([x] + faces)


@pytest.mark.parametrize("name", list(GRIDS))
def test_spec_matches_jax(name):
    j, p = _specs(name)
    assert p.offsets == j.offsets and p.table_size == j.table_size
    assert p.per_level_scale == j.per_level_scale and p.output_dim == j.output_dim
    for lvl in range(j.num_levels):
        assert p.level_scale(lvl) == j.level_scale(lvl)
        assert p.level_resolution(lvl) == j.level_resolution(lvl)
        assert p.level_uses_hash(lvl) == j.level_uses_hash(lvl)
    uses = [j.level_uses_hash(lvl) for lvl in range(j.num_levels)]
    assert any(uses) and not all(uses)  # every grid has dense and hashed levels


@pytest.mark.parametrize("name,mb,bytes_per_el", [
    ("tuned", 64, 2), ("upstream", 64, 2), ("small", 1024, 4), ("small", 0.03, 4),
    ("small_wide", 0.5, 2)])
def test_pack_plan_and_table_match_jax(name, mb, bytes_per_el):
    j, p = _specs(name)
    budget = int(mb * (1 << 20))
    jplan = jh.plan_packing(j, max_bytes=budget, bytes_per_el=bytes_per_el)
    pplan = ph.plan_packing(p, max_bytes=budget, bytes_per_el=bytes_per_el)
    assert pplan.packed_levels == jplan.packed_levels
    assert pplan.row_offsets == jplan.row_offsets
    assert pplan.row_width == jplan.row_width and pplan.total_rows == jplan.total_rows
    if name == "tuned":
        assert pplan.packed_levels == (0, 1) and pplan.row_offsets == (0, 4096, 73017)
    if name == "upstream" or not pplan.packed_levels:
        return  # the upstream pack is large; its plan is what matters here
    table = _table(p)
    for jdt, pdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        ref = np.asarray(jh.pack_hash_table(table, jplan, dtype=jdt).astype(jnp.float32))
        ours = ph.pack_hash_table(torch.from_numpy(table), pplan, dtype=pdt)
        assert ours.dtype == pdt
        np.testing.assert_array_equal(ours.float().numpy(), ref)


@pytest.mark.parametrize("name,bound", [
    ("small", 1.0), ("small_wide", 2.0), ("tuned", 2.0), ("upstream", 2.0)])
def test_hash_encode_matches_jax(name, bound):
    j, p = _specs(name)
    table = _table(p)
    x = _points(p, 400, bound)
    ref = np.asarray(jh.hash_encode(jnp.asarray(x), jnp.asarray(table), j, bound=bound))
    ours = ph.hash_encode(torch.from_numpy(x), torch.from_numpy(table), p, bound=bound)
    assert ours.shape == ref.shape and ours.dtype == torch.float32
    oob = np.any(np.abs(x) > bound, -1)
    assert oob.any() and (~oob).any()
    np.testing.assert_array_equal(ours.numpy()[oob], 0.0)
    np.testing.assert_allclose(ours.numpy(), ref, **F32_TOL)
    # a [B, P, 3] batch keeps its prefix
    x3 = torch.from_numpy(x[:40]).reshape(2, 20, 3)
    ours3 = ph.hash_encode(x3, torch.from_numpy(table), p, bound=bound)
    np.testing.assert_array_equal(ours3.reshape(40, -1).numpy(), ours.numpy()[:40])


@pytest.mark.parametrize("name", ["small", "tuned"])
def test_hash_encode_bf16_table_within_one_ulp_of_jax(name):
    j, p = _specs(name)
    table = _table(p, seed=2)
    x = _points(p, 300, 2.0, seed=3)
    ref = np.asarray(jh.hash_encode(jnp.asarray(x), jnp.asarray(table).astype(jnp.bfloat16), j,
                                    bound=2.0).astype(jnp.float32))
    ours = ph.hash_encode(torch.from_numpy(x), torch.from_numpy(table).to(torch.bfloat16), p,
                          bound=2.0)
    assert ours.dtype == torch.bfloat16
    diff = np.abs(ours.float().numpy() - ref)
    assert np.all(diff <= 8e-3 * np.abs(ref) + 1e-6), diff.max()
    # and against the f32 table, one bf16 rounding of the table and of the sum
    f32 = ph.hash_encode(torch.from_numpy(x), torch.from_numpy(table), p, bound=2.0).numpy()
    assert np.abs(ours.float().numpy() - f32).max() < 0.05 * np.abs(f32).max()


def test_hash_encode_level_subset_is_a_column_slice():
    _, p = _specs("tuned")
    table = torch.from_numpy(_table(p))
    x = torch.from_numpy(_points(p, 200, 2.0))
    full = ph.hash_encode(x, table, p, bound=2.0)
    part = ph.hash_encode(x, table, p, bound=2.0, levels=(2, 3))
    assert torch.equal(part, full[:, 2 * 8:])
    with pytest.raises(ValueError, match="levels"):
        ph.hash_encode(x, table, p, bound=2.0, levels=(4,))


@pytest.mark.parametrize("case", ["full", "partial", "bf16_pack", "tuned_bf16"])
def test_hash_encode_packed_matches_jax(case):
    """The cases of tests/test_ops.py:384-421, and the tuned grid served in
    bf16 (table and pack both bf16, as the sampler packs them)."""
    name = "tuned" if case == "tuned_bf16" else "small"
    j, p = _specs(name)
    table = _table(p)
    x = _points(p, 256, 1.0, seed=4)
    budget, bpe, jdt, pdt = {
        "full": (1 << 30, 4, jnp.float32, torch.float32),
        "partial": (30_000, 4, jnp.float32, torch.float32),
        "bf16_pack": (1 << 30, 4, jnp.bfloat16, torch.bfloat16),
        "tuned_bf16": (64 << 20, 2, jnp.bfloat16, torch.bfloat16),
    }[case]
    jplan = jh.plan_packing(j, max_bytes=budget, bytes_per_el=bpe)
    pplan = ph.plan_packing(p, max_bytes=budget, bytes_per_el=bpe)
    if case == "partial":
        assert 0 < len(pplan.packed_levels) < p.num_levels
    jt = jnp.asarray(table).astype(jnp.bfloat16) if case == "tuned_bf16" else jnp.asarray(table)
    pt = torch.from_numpy(table).to(torch.bfloat16 if case == "tuned_bf16" else torch.float32)
    ref = np.asarray(jh.hash_encode_packed(
        jnp.asarray(x), jt, jh.pack_hash_table(jt, jplan, dtype=jdt), jplan).astype(jnp.float32))
    ours = ph.hash_encode_packed(torch.from_numpy(x), pt, ph.pack_hash_table(pt, pplan, pdt),
                                 pplan)
    assert ours.dtype == pt.dtype and ours.shape == ref.shape
    if case in ("full", "partial"):
        np.testing.assert_allclose(ours.numpy(), ref, **F32_TOL)
        unpacked = ph.hash_encode(torch.from_numpy(x), pt, p)
        np.testing.assert_allclose(ours.numpy(), unpacked.numpy(), **F32_TOL)
    else:
        diff = np.abs(ours.float().numpy() - ref)
        assert np.all(diff <= 8e-3 * np.abs(ref) + 1e-6), diff.max()


def test_table_gather_matches_the_probe_expression():
    """``probe_pallas_gather.kernel`` (scripts/bench_packed_gather.py:128):
    ``o = t[i, :][..., 0]`` at [512, 128] f32 / [8, 128] i32, evaluated by
    JAX on the CPU."""
    table = np.arange(512 * 128, dtype=np.float32).reshape(512, 128)
    idx = np.random.default_rng(5).integers(0, 512, (8, 128)).astype(np.int32)
    idx[0, 0], idx[-1, -1] = 0, 511
    ref = np.asarray(jnp.asarray(table)[jnp.asarray(idx), :][..., 0])
    before = dict(_ext.LAUNCHES)
    ours = ph.table_gather(torch.from_numpy(table), torch.from_numpy(idx), col=0, ncols=1)
    assert ours.shape == (8, 128, 1) and ours.dtype == torch.float32
    np.testing.assert_array_equal(ours[..., 0].numpy(), ref)
    assert _ext.LAUNCHES == before  # the CPU runs the plain version


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_table_gather_columns_and_clamping(dtype):
    rng = np.random.default_rng(6)
    table = torch.from_numpy(rng.standard_normal((50, 64)).astype(np.float32)).to(
        getattr(torch, dtype))
    idx = torch.from_numpy(rng.integers(-5, 55, (3, 7)).astype(np.int32))
    got = ph.table_gather(table, idx, col=8, ncols=20)
    want = table[idx.long().clamp(0, 49)][..., 8:28]
    assert got.shape == (3, 7, 20) and torch.equal(got, want)
    assert torch.equal(ph.table_gather(table, idx), table[idx.long().clamp(0, 49)])
    with pytest.raises(ValueError, match="columns"):
        ph.table_gather(table, idx, col=60, ncols=8)


def test_wrappers_refuse_grad_mode():
    _, p = _specs("small")
    table = torch.from_numpy(_table(p)).requires_grad_()
    x = torch.zeros(4, 3)
    with pytest.raises(RuntimeError, match="no backward"):
        ph.hash_encode(x, table, p)
    with pytest.raises(RuntimeError, match="no backward"):
        ph.table_gather(table, torch.zeros(3, dtype=torch.int32))
    with torch.no_grad():
        assert ph.hash_encode(x, table, p).shape == (4, p.output_dim)


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_encode_matches_jax(degree):
    rng = np.random.default_rng(degree)
    d = rng.standard_normal((2, 64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = np.asarray(j_sh_encode(jnp.asarray(d), degree=degree))
    ours = sh_encode(torch.from_numpy(d), degree=degree).numpy()
    assert ours.shape == ref.shape == (2, 64, degree * degree)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
