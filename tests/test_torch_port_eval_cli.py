"""The port's ``eval``, ``calc_fid_stats`` and ``eval_files`` entries on the
CPU, beside the JAX CLIs where those run here (the FID Inception, FID /
KID and eval's images are in ``test_torch_port_eval.py``).

Both packages' CLIs read the same pytorch-fid weights file: the port's
seeded Inception's state dict (no Inception weights are in the
repository); the generator is ``test_torch_port_mesh.tiny_workspace``'s.
Each FID is a 2048^2 ``sqrtm`` (~20 s on two threads), which bounds this
file's time.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sdface_gan_tpu_torch import calc_fid_stats as calc_cli  # noqa: E402
from sdface_gan_tpu_torch import eval as eval_cli  # noqa: E402
from sdface_gan_tpu_torch import eval_files as eval_files_cli  # noqa: E402
from sdface_gan_tpu_torch.data.png import encode_png  # noqa: E402
from sdface_gan_tpu_torch.evaluation.inception import InceptionV3  # noqa: E402
from sdface_gan_tpu_torch.ops import _ext  # noqa: E402

from test_torch_port_mesh import tiny_workspace  # noqa: E402


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


# ---------------------------------------------------------------- the CLIs

@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """``tiny_workspace`` plus ten procedural PNG heads, a store of them and
    a seeded Inception's weights as a pytorch-fid file."""
    root = tiny_workspace(tmp_path_factory.mktemp("eval_cli"))
    from sdface_gan_tpu_torch.data import synthetic

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        synthetic.main(["--out", "store", "--n", "10", "--res", "16", "--seed", "1"])
    weights = InceptionV3(device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    torch.save({k: v for k, v in weights.items() if not k.endswith("num_batches_tracked")},
               root / "inception.pth")
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


