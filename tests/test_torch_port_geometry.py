"""The port's cameras, rays and depth sampling against the JAX package.

JAX and torch random streams never match, so random draws are made on
one side and handed to the other as arrays.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdface_gan_tpu.geometry import cameras as j_cam  # noqa: E402
from sdface_gan_tpu.geometry import rays as j_rays  # noqa: E402
from sdface_gan_tpu.models import renderer as j_renderer  # noqa: E402
from sdface_gan_tpu_torch.geometry import cameras, rays  # noqa: E402
from sdface_gan_tpu_torch.models import renderer  # noqa: E402

ATOL = 1e-5


def _cams_close(ours, ref):
    for name in ("extrinsics", "focal", "near", "far", "viewpoint"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=ATOL,
                                   err_msg=name)


def test_camera_locations_path():
    rng = np.random.default_rng(0)
    loc = np.stack([rng.uniform(-0.5, 0.5, 5), rng.uniform(-0.3, 0.3, 5)], 1)
    loc[-1] = (0.2, 1.5707)  # near the up-axis degeneracy fix
    loc = loc.astype(np.float32)
    ours = cameras.generate_camera_params(64, batch=5, locations=torch.from_numpy(loc))
    ref = j_cam.generate_camera_params(64, None, batch=5, locations=jnp.asarray(loc))
    _cams_close(ours, ref)


def test_camera_sweep_path_with_elevation_given():
    """The sweep's azimuths are fixed; its per-identity elevation is drawn
    from the torch generator here and given to the JAX locations path."""
    batch, seed, elev_range = 2, 5, 0.15
    ours = cameras.generate_camera_params(
        64, torch.Generator().manual_seed(seed), batch=batch, sweep=True, device="cpu")
    u = torch.rand((batch, 1), generator=torch.Generator().manual_seed(seed)).numpy()
    elev = np.repeat(-elev_range + 2 * elev_range * u, 8, axis=0)
    ref_sweep = j_cam.generate_camera_params(64, jax.random.PRNGKey(0), batch=batch, sweep=True)
    azim = np.asarray(ref_sweep.viewpoint)[:, :1]
    ref = j_cam.generate_camera_params(
        64, None, locations=jnp.asarray(np.concatenate([azim, elev], 1)))
    _cams_close(ours, ref)


def test_camera_random_paths_are_seeded_and_in_range():
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = cameras.generate_camera_params(64, g(), batch=256, device="cpu")
    b = cameras.generate_camera_params(64, g(), batch=256, device="cpu")
    assert torch.equal(a.extrinsics, b.extrinsics)
    std = a.viewpoint.std(0)
    assert abs(std[0].item() - 0.3) < 0.06 and abs(std[1].item() - 0.15) < 0.03
    u = cameras.generate_camera_params(64, g(), batch=256, uniform=True, device="cpu")
    assert u.viewpoint[:, 0].abs().max() <= 0.3 and u.viewpoint[:, 1].abs().max() <= 0.15
    with pytest.raises(ValueError):
        cameras.generate_camera_params(64, None, batch=2, device="cpu")


@pytest.mark.parametrize("static_viewdirs", [False, True])
def test_get_rays(static_viewdirs):
    rng = np.random.default_rng(1)
    loc = np.stack([rng.uniform(-0.3, 0.3, 3), rng.uniform(-0.15, 0.15, 3)], 1).astype(np.float32)
    jc = j_cam.generate_camera_params(16, None, locations=jnp.asarray(loc))
    ref = j_rays.get_rays(jc.focal, jc.extrinsics, 16, static_viewdirs=static_viewdirs)
    ours = rays.get_rays(torch.from_numpy(np.array(jc.focal)),
                         torch.from_numpy(np.array(jc.extrinsics)), 16,
                         static_viewdirs=static_viewdirs)
    for name in ("origins", "directions", "viewdirs"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=ATOL, err_msg=name)


@pytest.mark.parametrize("n,offset", [(6, True), (24, True), (24, False)])
def test_base_t_vals(n, offset):
    np.testing.assert_allclose(rays.base_t_vals(n, offset, "cpu").numpy(),
                               np.asarray(j_rays.base_t_vals(n, offset)), atol=ATOL)


@pytest.mark.parametrize("offset", [True, False])
def test_sample_z_vals_deterministic(offset):
    kw = dict(out_im_res=8, n_samples=6, offset_sampling=offset)
    near = np.full((2, 1, 1, 1), 0.88, np.float32)
    far = np.full((2, 1, 1, 1), 1.12, np.float32)
    ref = j_renderer._sample_z_vals(j_renderer.RendererConfig(**kw), jnp.asarray(near),
                                    jnp.asarray(far), 2, None)
    ours = renderer._sample_z_vals(renderer.RendererConfig(**kw), torch.from_numpy(near),
                                   torch.from_numpy(far), 2, None)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL)
    # with a generator the jitter stays inside [near, far]
    jit = renderer._sample_z_vals(renderer.RendererConfig(**kw), torch.from_numpy(near),
                                  torch.from_numpy(far), 2, torch.Generator().manual_seed(0))
    assert jit.shape == ours.shape
    assert bool((jit >= 0.88 - 1e-6).all()) and bool((jit <= 1.12 + 1e-6).all())
