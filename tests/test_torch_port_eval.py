"""The port's evaluation against the JAX package: the FID Inception, FID /
KID and eval's images on the CPU (the ``eval``, ``calc_fid_stats`` and
``eval_files`` entries are in ``test_torch_port_eval_cli.py``, a file of
their own so that the suite's workers can run both at once).

The JAX Inception's random init is carried into the port by
``jax_inception_params_to_state_dict`` (no Inception weights are in the
repository); the generator comes from one reference-layout state dict, as
in ``test_torch_port_models.py``.  Each JAX-side computation is the JAX
package's own code on the same numpy inputs.  The geometry tools' tests
are in ``test_torch_port_mesh.py``.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sdface_gan_tpu.evaluation import fid as j_fid  # noqa: E402
from sdface_gan_tpu.evaluation.inception import inception_pool3, init_inception  # noqa: E402
from sdface_gan_tpu.geometry import generate_camera_params as j_cams  # noqa: E402
from sdface_gan_tpu.models import generator as j_gen  # noqa: E402
from sdface_gan_tpu.utils.torch_import import import_generator_state  # noqa: E402
from sdface_gan_tpu_torch import eval as eval_cli  # noqa: E402
from sdface_gan_tpu_torch.evaluation import fid  # noqa: E402
from sdface_gan_tpu_torch.evaluation.inception import InceptionV3, load_inception  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import jax_inception_params_to_state_dict  # noqa: E402

from test_torch_port_models import DEPTH, IMAGE_TOL, RES, SIZE, _configs, _port_model  # noqa: E402
from test_torch_port_mesh import _port_cams, case  # noqa: E402,F401

@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two threads for torch and BLAS while this module runs: its FIDs'
    2048^2 ``sqrtm`` and CPU Inceptions otherwise oversubscribe a machine
    that runs the suite in several workers at once."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(2):
            yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------- Inception

@pytest.fixture(scope="module")
def inception():
    """JAX's random init (jitted: eagerly it compiles each of its ~100 draws
    apart) and the port's model holding it."""
    params = jax.jit(init_inception)(jax.random.PRNGKey(0))
    model = InceptionV3(device="cpu")
    model.load_state_dict(jax_inception_params_to_state_dict(params), strict=False)
    return params, model


def test_converter_carries_every_tensor_bit_for_bit(inception):
    params, model = inception
    sd = jax_inception_params_to_state_dict(params)
    ours = model.state_dict()
    assert set(sd) == {k for k in ours if not k.endswith("num_batches_tracked")}
    np.testing.assert_array_equal(sd["Mixed_7c.branch3x3dbl_3b.conv.weight"].numpy(),
                                  np.transpose(np.asarray(params["Mixed_7c"]["b3d_3b"]["w"]),
                                               (3, 2, 0, 1)))
    np.testing.assert_array_equal(sd["Conv2d_1a_3x3.bn.running_var"].numpy(),
                                  np.asarray(params["Conv2d_1a_3x3"]["bn_var"]))
    for k, v in sd.items():
        np.testing.assert_array_equal(ours[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("size", [64, 256, 512])
def test_inception_pool3_matches_jax(inception, size):
    """64 and 256 grow to 299 (bilinear), 512 shrinks (antialiased)."""
    params, model = inception
    x = np.random.default_rng(size).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    ref = np.asarray(inception_pool3(params, jnp.asarray(x)))
    with torch.no_grad():
        ours = model(torch.from_numpy(x)).numpy()
    assert ours.shape == (2, 2048)
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()


def test_load_inception_reads_a_pytorch_fid_state_dict(inception, tmp_path):
    """pytorch-fid's file also holds the classifier, the auxiliary head and
    BatchNorm counters; the pool3 tensors load, the rest is left out."""
    params, model = inception
    state = jax_inception_params_to_state_dict(params)
    extra = {"fc.weight": torch.zeros(1008, 2048), "fc.bias": torch.zeros(1008),
             "AuxLogits.conv0.conv.weight": torch.zeros(128, 768, 1, 1),
             "Mixed_5b.branch1x1.bn.num_batches_tracked": torch.tensor(0)}
    torch.save({**state, **extra}, tmp_path / "pt_inception.pth")
    loaded = load_inception(str(tmp_path / "pt_inception.pth"), device="cpu")
    for k, v in state.items():
        np.testing.assert_array_equal(loaded.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    del state["Mixed_6c.branch_pool.bn.running_mean"]
    torch.save(state, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="lacks 1 FID Inception tensors"):
        load_inception(str(tmp_path / "short.pth"), device="cpu")


def test_compute_activations_regroups_batches(inception):
    params, model = inception
    rng = np.random.default_rng(9)
    imgs = rng.uniform(-1, 1, (5, 32, 32, 3)).astype(np.float32)
    ours = fid.compute_activations(model, [imgs[:2], torch.from_numpy(imgs[2:3]), imgs[3:]],
                                   batch_size=3)
    ref = j_fid.compute_activations(params, [imgs[:2], imgs[2:3], imgs[3:]], batch_size=3)
    assert ours.shape == (5, 2048)
    assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max()


# ---------------------------------------------------------------- FID / KID

def _acts(seed, n, d, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) @ rng.standard_normal((d, d)) * 0.3 + shift).astype(
        np.float32)


@pytest.mark.parametrize("n,d", [(64, 16), (40, 64), (12, 32)])
def test_fid_and_kid_match_jax(n, d):
    a, b = _acts(1, n, d), _acts(2, n + 3, d, shift=0.2)
    for ours, ref in (
            (fid.fid_from_activations(a, b), j_fid.fid_from_activations(a, b)),
            (fid.calculate_frechet_distance(*fid.calculate_activation_statistics(a),
                                            *fid.calculate_activation_statistics(b)),
             j_fid.calculate_frechet_distance(*j_fid.calculate_activation_statistics(a),
                                              *j_fid.calculate_activation_statistics(b)))):
        assert abs(ours - ref) <= 1e-9 * abs(ref)
    for ours, ref in zip(fid.calculate_kid(a, b, n_subsets=7, subset_size=10, seed=3),
                         j_fid.calculate_kid(a, b, n_subsets=7, subset_size=10, seed=3)):
        assert abs(ours - ref) <= 1e-9 * abs(ref)


def test_fid_raises_on_a_large_imaginary_part_as_jax_does(monkeypatch):
    """A complex square root whose diagonal is not real within 1e-3 raises
    the same ``ValueError`` in both packages; a negligible one is dropped."""
    from scipy import linalg

    a = _acts(3, 30, 8)
    mu, sigma = fid.calculate_activation_statistics(a)
    real_sqrtm = linalg.sqrtm
    for imag, raises in ((1e-2, True), (1e-5, False)):
        monkeypatch.setattr(linalg, "sqrtm", lambda m, imag=imag: real_sqrtm(m) + 1j * imag)
        if raises:
            with pytest.raises(ValueError) as ours:
                fid.calculate_frechet_distance(mu, sigma, mu, sigma)
            with pytest.raises(ValueError) as theirs:
                j_fid.calculate_frechet_distance(mu, sigma, mu, sigma)
            assert str(ours.value) == str(theirs.value)
        else:
            assert abs(fid.calculate_frechet_distance(mu, sigma, mu, sigma)
                       - j_fid.calculate_frechet_distance(mu, sigma, mu, sigma)) <= 1e-9


@pytest.mark.parametrize("keys", ["mu_sigma", "m_s"])
def test_load_stats_npz_matches_jax(tmp_path, keys):
    mu, sigma = np.arange(4.0), np.eye(4)
    path = str(tmp_path / "stats.npz")
    if keys == "mu_sigma":
        np.savez(path, mu=mu, sigma=sigma, img_size=64)
    else:
        np.savez(path, m=mu, s=sigma)
    for load in (fid.load_stats_npz, j_fid.load_stats_npz):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = load(path, expect_img_size=64)
        np.testing.assert_array_equal(got[0], mu)
        np.testing.assert_array_equal(got[1], sigma)
    if keys == "mu_sigma":
        with pytest.warns(UserWarning, match="img_size=64") as ours:
            fid.load_stats_npz(path, expect_img_size=32)
        with pytest.warns(UserWarning, match="img_size=64") as theirs:
            j_fid.load_stats_npz(path, expect_img_size=32)
        assert str(ours[0].message) == str(theirs[0].message)


# ------------------------------------------------- generator-side tools vs JAX

def test_eval_images_match_jax(case):
    """eval's generation with explicit cameras and no noise key (fixed
    depths, stored noise), through the fused field's CPU path."""
    state, z = case["state"], case["z"]
    jcfg, pcfg = _configs()
    params = import_generator_state(state, renderer_type="sdf", depth=DEPTH)
    gcfg = eval_cli.eval_generator_config(pcfg)
    assert gcfg.renderer.use_fused_kernel
    cams = j_cams(RES, jax.random.PRNGKey(7), batch=2)
    model = _port_model(state, pcfg)
    from sdface_gan_tpu_torch.ops.siren_kernel import pack_siren_field

    with torch.no_grad():
        ours = eval_cli.sample_images(model, gcfg, torch.from_numpy(z), _port_cams(cams),
                                      field_pack=pack_siren_field(model.renderer.network))
    ref = j_gen.generator_forward(params, jcfg, [jnp.asarray(z)], cams.extrinsics, cams.focal,
                                  cams.near, cams.far, key=None)
    assert ours.dtype == torch.float32 and ours.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref.rgb), **IMAGE_TOL)
