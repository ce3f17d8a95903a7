"""The port's evaluation against the JAX package: the FID Inception, FID /
KID, eval's images, and the ``eval``, ``calc_fid_stats`` and ``eval_files``
entries on the CPU.

The JAX Inception's random init is carried into the port by
``jax_inception_params_to_state_dict`` (no Inception weights are in the
repository); the generator comes from one reference-layout state dict, as
in ``test_torch_port_models.py``.  Each JAX-side computation is the JAX
package's own code on the same numpy inputs.  The geometry tools' tests
are in ``test_torch_port_mesh.py``.
"""

import os
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
from sdface_gan_tpu_torch import calc_fid_stats as calc_cli  # noqa: E402
from sdface_gan_tpu_torch import eval as eval_cli  # noqa: E402
from sdface_gan_tpu_torch import eval_files as eval_files_cli  # noqa: E402
from sdface_gan_tpu_torch.data.png import encode_png  # noqa: E402
from sdface_gan_tpu_torch.evaluation import fid  # noqa: E402
from sdface_gan_tpu_torch.evaluation.inception import InceptionV3, load_inception  # noqa: E402
from sdface_gan_tpu_torch.ops import _ext  # noqa: E402
from sdface_gan_tpu_torch.utils.convert import jax_inception_params_to_state_dict  # noqa: E402

from test_torch_port_models import DEPTH, IMAGE_TOL, RES, SIZE, _configs, _port_model  # noqa: E402
from test_torch_port_mesh import _port_cams, case, tiny_workspace  # noqa: E402,F401

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
    params = init_inception(jax.random.PRNGKey(0))
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


# ---------------------------------------------------------------- the CLIs

@pytest.fixture(scope="module")
def ws(tmp_path_factory, inception):
    """``tiny_workspace`` plus ten procedural PNG heads, a store of them and
    the JAX Inception's weights as a pytorch-fid file."""
    root = tiny_workspace(tmp_path_factory.mktemp("eval_cli"))
    from sdface_gan_tpu_torch.data import synthetic

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        synthetic.main(["--out", "store", "--n", "10", "--res", "16", "--seed", "1"])
    torch.save(jax_inception_params_to_state_dict(inception[0]), root / "inception.pth")
    return root


@pytest.fixture(autouse=False)
def in_ws(ws, monkeypatch):
    monkeypatch.chdir(ws)
    return ws


def test_calc_fid_stats_matches_the_jax_cli(in_ws, capsys):
    """Both CLIs on the same PNG heads and Inception weights; the images
    are LANCZOS-resized 16 -> 24 (PIL there, the port's resampler here)."""
    import calc_fid_stats as j_calc

    args = ["store_png", "--img_size", "24", "--batch", "4",
            "--inception_weights", "inception.pth"]
    n = calc_cli.main(args + ["--out", "ours.npz", "--device", "cpu"])
    j_calc.main(args + ["--out", "ref.npz"])
    assert n == 10 and "wrote stats for 10 images" in capsys.readouterr().out
    with np.load("ours.npz") as a, np.load("ref.npz") as b:
        assert int(a["img_size"]) == 24
        np.testing.assert_allclose(a["mu"], b["mu"], rtol=0, atol=1e-4 * np.abs(b["mu"]).max())
        np.testing.assert_allclose(a["sigma"], b["sigma"], rtol=0,
                                   atol=1e-4 * np.abs(b["sigma"]).max())


@pytest.fixture(scope="module")
def stats16(ws):
    """FID stats of the heads at their own 16² (the port's CLI)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(ws)
        calc_cli.main(["store_png", "--out", "stats16.npz", "--img_size", "16", "--batch", "5",
                       "--inception_weights", "inception.pth", "--device", "cpu"])
    return "stats16.npz"


@pytest.fixture(scope="module")
def scored(ws):
    """Six images, not the stats' ones, as a PNG directory, an NCHW uint8
    array and an NHWC float array in [-1, 1]."""
    from sdface_gan_tpu_torch.evaluation.real import dir_batches, list_image_files

    imgs = np.concatenate(list(dir_batches(str(ws / "store_png"),
                                           list_image_files(str(ws / "store_png")), 4)))
    u8 = np.clip((imgs[:6] * 0.8 + 1.0) * 127.5, 0, 255).round().astype(np.uint8)
    (ws / "scored").mkdir()
    for i, img in enumerate(u8):
        (ws / "scored" / f"{i}.png").write_bytes(encode_png(img))
    np.save(ws / "nchw.npy", np.transpose(u8, (0, 3, 1, 2)))
    np.save(ws / "nhwc.npy", u8.astype(np.float32) / 127.5 - 1.0)
    return u8


def test_eval_files_reads_arrays_and_directories(in_ws, scored):
    """An NCHW uint8 array, the same images NHWC in [-1, 1] and their PNG
    directory give the same batches."""
    got = {}
    for path in ("nchw.npy", "nhwc.npy", "scored"):
        batches, size = eval_files_cli.image_batches(path, 4)
        got[path] = np.concatenate(list(batches))
        assert size == 16 and got[path].dtype == np.float32
    np.testing.assert_array_equal(got["nchw.npy"], got["scored"])
    np.testing.assert_allclose(got["nhwc.npy"], got["scored"], rtol=0, atol=1e-6)


def test_eval_files_matches_the_jax_cli(in_ws, stats16, scored, capsys):
    """The port on the NCHW array, the JAX CLI on the PNG directory of the
    same images, the same Inception weights and stats."""
    import eval_files as j_eval_files

    common = ["--fid_file", stats16, "--batch", "4", "--inception_weights", "inception.pth"]
    ours = eval_files_cli.main(["nchw.npy", *common, "--device", "cpu"])
    j_eval_files.main(["scored", *common])
    ref = float(capsys.readouterr().out.strip().splitlines()[-1].split()[-1])
    assert np.isfinite(ours) and abs(ours - ref) <= 1e-3 * abs(ref) + 1e-3


def test_eval_no_dump_scores_against_a_stats_file(in_ws, stats16, capsys):
    before = dict(_ext.LAUNCHES)
    stats = eval_cli.main(["--config", "tiny.yaml", "--n_images", "6", "--batch", "4",
                           "--no_dump", "--fid_file", stats16, "--inception_weights",
                           "inception.pth", "--device", "cpu"])
    out = capsys.readouterr().out
    assert _ext.LAUNCHES == before  # the CPU runs the kernels' plain versions
    assert stats["n_images"] == 6 and np.isfinite(stats["fid"])
    assert "precision: f32 matmuls and convolutions without TF32" in out
    assert f"FID: {stats['fid']:.4f}" in out and "no image dump" in out
    assert not os.listdir(in_ws / "out" / "tiny" / "eval")


def test_a_store_and_its_png_directory_give_the_same_real_images(in_ws):
    from sdface_gan_tpu_torch.evaluation.real import (
        dir_batches,
        is_record_store,
        list_image_files,
        store_batches,
    )

    assert is_record_store("store") == "store" and is_record_store("store_png") is None
    a = np.concatenate(list(store_batches("store", 16, 7, 3)))
    b = np.concatenate(list(dir_batches("store_png", list_image_files("store_png", 7), 3, 16)))
    assert a.shape == (7, 16, 16, 3)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("source", ["store", "png_dir", "jpeg_dir"])
def test_eval_dumps_and_scores_against_real_images(in_ws, capsys, source):
    """FID and KID against the record store, its PNG directory or those
    images as JPEG files, with the PNG dump; bf16 weights on the CPU too."""
    real = {"store": "store", "png_dir": "store_png", "jpeg_dir": "store_jpeg"}[source]
    if source == "jpeg_dir" and not os.path.isdir(real):
        from PIL import Image

        os.makedirs(real)
        for name in sorted(os.listdir("store_png")):
            Image.open(os.path.join("store_png", name)).save(
                os.path.join(real, name[:-4] + ".jpg"), quality=90)
    stats = eval_cli.main(["--config", "tiny.yaml", "--n_images", "5", "--batch", "2",
                           "--real_dir", real, "--device", "cpu"])
    out = capsys.readouterr().out
    assert np.isfinite(stats["fid"]) and np.isfinite(stats["kid_mean"])
    assert f"KID: {stats['kid_mean']:.6f}" in out
    dumped = sorted(os.listdir(in_ws / "out" / "tiny" / "eval"))
    assert dumped == [f"{i:07d}.png" for i in range(5)]
    if source == "png_dir":
        b16 = eval_cli.main(["--config", "tiny.yaml", "--n_images", "4", "--batch", "2",
                             "--g_dtype", "bfloat16", "--no_fid", "--device", "cpu"])
        assert b16["n_images"] == 4


def test_eval_refuses_before_generating(in_ws, tmp_path):
    eval_dir = in_ws / "out" / "tiny" / "eval"
    before = set(os.listdir(eval_dir)) if eval_dir.exists() else set()
    with pytest.raises(SystemExit, match="--no_dump produces no PNGs"):
        eval_cli.main(["--config", "tiny.yaml", "--n_images", "2", "--no_dump",
                       "--device", "cpu"])
    (tmp_path / "a.png").write_bytes(encode_png(np.zeros((16, 16, 3), np.uint8)))
    (tmp_path / "b.jpg").write_bytes(b"\xff\xd8\xff")  # a JPEG cut after its first bytes
    with pytest.raises(ValueError, match="b.jpg: corrupt or truncated JPEG"):
        eval_cli.main(["--config", "tiny.yaml", "--n_images", "2", "--real_dir",
                       str(tmp_path), "--device", "cpu"])
    assert set(os.listdir(eval_dir)) == before
    # a whole JPEG is read as PIL reads it
    from PIL import Image

    from sdface_gan_tpu_torch.evaluation.real import dir_batches, list_image_files

    rng = np.random.default_rng(2)
    Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(tmp_path / "b.jpg")
    names = list_image_files(str(tmp_path))
    got = next(dir_batches(str(tmp_path), names, 2))[1]
    want = np.asarray(Image.open(tmp_path / "b.jpg").convert("RGB"))
    np.testing.assert_array_equal(got, want.astype(np.float32) / 127.5 - 1.0)


