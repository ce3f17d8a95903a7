"""The port's data layer against the JAX package and PIL, on the CPU.

* record store: the same puts give byte-equal files, and each package
  reads the other's store;
* PNG: ``data.png.decode_png`` against ``PIL.Image.open(...).convert("RGB")``;
* resampling: ``data.resample.resize`` against PIL's HAMMING and LANCZOS;
* dataset, loader and prepare against ``sdface_gan_tpu.data``.

Every comparison is exact (bit-equal uint8, equal float32): the port
reproduces PIL's arithmetic, and the [-1, 1] conversion is the same numpy
expression in both packages.
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from sdface_gan_tpu.data import DataLoader as JDataLoader
from sdface_gan_tpu.data import MultiResolutionDataset as JDataset
from sdface_gan_tpu.data import prepare_data as j_prepare
from sdface_gan_tpu.native import RecordReader as JReader
from sdface_gan_tpu.native import RecordWriter as JWriter
from sdface_gan_tpu_torch.data import DataLoader, MultiResolutionDataset, prepare_data
from sdface_gan_tpu_torch.data import png
from sdface_gan_tpu_torch.data.prepare import list_images
from sdface_gan_tpu_torch.data.resample import resize
from sdface_gan_tpu_torch.native import RecordReader, RecordWriter
from sdface_gan_tpu_torch.utils.images import write_png

from test_torch_port_images import png_bytes  # noqa: E402

def _pil_png(arr: np.ndarray, mode: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG")
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _pattern(kind: str, h: int, w: int, c: int, seed: int = 0) -> np.ndarray:
    if kind == "noise":
        return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)
    if kind == "flat":
        return np.full((h, w, c), 113, np.uint8)
    yy, xx = np.mgrid[:h, :w]
    chans = [xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + 2 * yy) % 256,
             (3 * xx + yy) % 256]
    return np.stack(chans[:c], -1).astype(np.uint8)


# ------------------------------------------------------------- record store
def _puts():
    rng = np.random.default_rng(3)
    puts = [(f"32-{i:05d}", rng.integers(0, 256, int(rng.integers(0, 300)),
                                         dtype=np.uint8).tobytes()) for i in range(7)]
    return puts + [("length", b"7")]


def test_record_store_files_are_byte_equal_and_cross_readable(tmp_path):
    puts = _puts()
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for writer, path in ((JWriter, jdir), (RecordWriter, pdir)):
        with writer(path) as w:
            for k, v in puts:
                w.put(k, v)
    for name in ("data.bin", "index.bin"):
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(pdir, name), "rb") as b:
            assert a.read() == b.read(), name
    for reader, path in ((RecordReader, jdir), (JReader, pdir)):
        with reader(path) as r:
            assert len(r) == len(puts)
            assert list(r.keys()) == [k for k, _ in puts]
            for k, v in puts:
                assert r.get(k) == v, k
            assert r.get("missing") is None


def test_closed_reader_raises_like_the_jax_reader(tmp_path):
    path = str(tmp_path / "store")
    with RecordWriter(path) as w:
        w.put("length", b"0")
    errors = []
    for reader in (JReader, RecordReader):
        r = reader(path)
        r.close()
        r.close()  # idempotent
        msgs = []
        for call in (lambda: r.get("length"), lambda: len(r), lambda: list(r.keys())):
            with pytest.raises(ValueError) as exc:
                call()
            msgs.append(str(exc.value))
        errors.append(msgs)
    assert errors[0] == errors[1]
    with pytest.raises(IOError):
        RecordReader(str(tmp_path / "absent"))


# ---------------------------------------------------------------------- PNG
@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
@pytest.mark.parametrize("kind,shape", [("gradient", (256, 256)), ("noise", (256, 256)),
                                        ("flat", (40, 56)), ("noise", (1, 97)),
                                        ("gradient", (83, 1))])
def test_png_decode_matches_pil(mode, kind, shape):
    c = {"RGB": 3, "RGBA": 4, "L": 1, "LA": 2}[mode]
    arr = _pattern(kind, *shape, c)
    data = _pil_png(arr[..., 0] if c == 1 else arr, mode)
    out = png.decode_png(data)
    assert out.dtype == np.uint8 and out.shape == shape + (3,)
    np.testing.assert_array_equal(out, _pil_rgb(data))


def _row_filter_types(data: bytes):
    hdr, idat = png.parse(data)
    c = {0: 1, 2: 3, 4: 2, 6: 4}[hdr.color_type]
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * (hdr.width * c + 1)] for y in range(hdr.height)}, len(idat)


def _hand_filtered_png(arr: np.ndarray, types, n_idat: int) -> bytes:
    """An 8-bit PNG whose row y uses filter ``types[y % len(types)]``, its
    zlib stream split over ``n_idat`` IDAT chunks."""
    h, w, c = arr.shape
    x = arr.reshape(h, w * c).astype(np.int32)
    left = np.zeros_like(x)
    left[:, c:] = x[:, :-c]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, c:] = x[:-1, :-c]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    pred = {0: np.zeros_like(x), 1: left, 2: up, 3: (left + up) // 2, 4: paeth}
    rows = b"".join(bytes([types[y % len(types)]])
                    + ((x[y] - pred.get(types[y % len(types)], pred[0])[y]) % 256).astype(np.uint8).tobytes()
                    for y in range(h))
    z = zlib.compress(rows, 9)
    cuts = np.linspace(0, len(z), n_idat + 1).astype(int)

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + b"".join(chunk(b"IDAT", z[a:b]) for a, b in zip(cuts[:-1], cuts[1:]))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_decode_every_filter_type_and_split_idat(channels):
    """PIL writes filters 0, 1, 2 and 4 and splits large images over several
    IDAT chunks; a hand-built file adds Average (3) and every other type in
    every colour type."""
    seen = set()
    for kind in ("gradient", "noise"):
        data = _pil_png(_pattern(kind, 256, 256, 3), "RGB")
        types, n_idat = _row_filter_types(data)
        seen |= types
        np.testing.assert_array_equal(png.decode_png(data), _pil_rgb(data))
    assert seen >= {0, 1, 2, 4} and n_idat > 1
    arr = _pattern("noise", 61, 47, channels, seed=channels) // 2 + _pattern(
        "gradient", 61, 47, channels) // 2
    data = _hand_filtered_png(arr, (0, 1, 2, 3, 4, 3, 4), n_idat=5)
    assert _row_filter_types(data) == ({0, 1, 2, 3, 4}, 5)
    np.testing.assert_array_equal(png.decode_png(data), _pil_rgb(data))


def test_png_port_writer_round_trips(tmp_path):
    rgb = _pattern("noise", 33, 71, 3)
    path = str(tmp_path / "x.png")
    write_png(path, rgb)
    data = open(path, "rb").read()
    np.testing.assert_array_equal(png.decode_png(data), rgb)
    np.testing.assert_array_equal(_pil_rgb(data), rgb)


def test_png_refuses_what_the_stores_never_hold():
    """Palette, 16-bit and interlaced files, which the record stores never
    hold, decode as PIL decodes them; a file whose IHDR says interlaced but
    whose data is not, a bad CRC, filter type 5 and a bad signature raise."""
    grey = _pattern("gradient", 20, 30, 1)[..., 0]
    palette = Image.fromarray(_pattern("gradient", 20, 30, 3)).convert("P")
    buf = io.BytesIO()
    palette.save(buf, format="PNG")
    np.testing.assert_array_equal(png.decode_png(buf.getvalue()), _pil_rgb(buf.getvalue()))
    buf = io.BytesIO()
    Image.fromarray(grey.astype(np.uint16) * 257).save(buf, format="PNG")
    assert png.parse(buf.getvalue())[0].bit_depth == 16
    np.testing.assert_array_equal(png.decode_png(buf.getvalue()), _pil_rgb(buf.getvalue()))
    rgb = _pattern("noise", 5, 4, 3)
    interlaced = png_bytes(rgb, 2, 8, 1)
    assert png.parse(interlaced)[0].interlace == 1
    np.testing.assert_array_equal(png.decode_png(interlaced), rgb)
    np.testing.assert_array_equal(_pil_rgb(interlaced), rgb)
    good = _hand_filtered_png(rgb, (1,), 1)
    flipped = bytearray(good)
    flipped[28] = 1  # IHDR interlace byte over non-interlaced data; fix its CRC
    flipped[29:33] = struct.pack(">I", zlib.crc32(bytes(flipped[12:29])) & 0xFFFFFFFF)
    with pytest.raises(ValueError, match="too short|filter type"):
        png.decode_png(bytes(flipped))
    bad_crc = bytearray(good)
    bad_crc[30] ^= 1
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(bytes(bad_crc))
    with pytest.raises(ValueError, match="filter type 5"):
        png.decode_png(_hand_filtered_png(_pattern("noise", 5, 4, 3), (5,), 1))
    with pytest.raises(ValueError, match="signature"):
        png.decode_png(b"GIF89a" + good[6:])


# --------------------------------------------------------------- resampling
@pytest.mark.parametrize("src,out", [(256, 64), (128, 64), (256, 32), (100, 64)])
@pytest.mark.parametrize("kind", ["noise", "gradient"])
def test_hamming_thumb_is_bit_equal_to_pil(src, out, kind):
    img = _pattern(kind, src, src, 3, seed=src)
    ref = np.asarray(Image.fromarray(img).resize((out, out), Image.HAMMING))
    np.testing.assert_array_equal(resize(img, (out, out), "hamming"), ref)


@pytest.mark.parametrize("size", [16, 64, 256])
@pytest.mark.parametrize("src_hw", [(288, 320), (300, 200), (90, 100)])
def test_lanczos_shorter_side_resize_is_bit_equal_to_pil(size, src_hw):
    """The prepare step's resize (shorter side to ``size``), down and up."""
    h, w = src_hw
    img = (_pattern("noise", h, w, 3, seed=size) // 2 + _pattern("gradient", h, w, 3) // 2)
    if w <= h:
        nw, nh = size, max(size, round(size * h / w))
    else:
        nw, nh = max(size, round(size * w / h)), size
    ref = np.asarray(Image.fromarray(img).resize((nw, nh), Image.LANCZOS))
    np.testing.assert_array_equal(resize(img, (nw, nh), "lanczos"), ref)


def test_resize_of_an_unchanged_size_is_a_copy():
    img = _pattern("noise", 16, 16, 3)
    np.testing.assert_array_equal(resize(img, (16, 16), "hamming"), img)
    with pytest.raises(ValueError):
        resize(img, (8, 8), "bicubic")


# ------------------------------------------------- dataset, loader, prepare
def _image_dir(root, shapes, seed=0):
    d = root / "imgs"
    d.mkdir()
    rng = np.random.default_rng(seed)
    for i, (h, w) in enumerate(shapes):
        arr = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8) // 2
               + _pattern("gradient", h, w, 3) // 2)
        Image.fromarray(arr).save(d / f"{i:03d}.png")
    return d


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """Six images at 32^2 (and 16^2), written by the JAX package's prepare."""
    root = tmp_path_factory.mktemp("data")
    d = _image_dir(root, [(40, 40)] * 6)
    path = str(root / "store")
    assert j_prepare(str(d), path, sizes=(16, 32), n_workers=1) == 6
    return path


def test_dataset_items_equal_the_jax_dataset(store):
    ours, ref = MultiResolutionDataset(store, 32, 16), JDataset(store, 32, 16)
    try:
        assert len(ours) == len(ref) == 6
        flips = set()
        for i in range(6):
            for s in range(4):
                a = ours.__getitem__(i, np.random.default_rng(s))
                b = ref.__getitem__(i, np.random.default_rng(s))
                flips.add(bool(np.random.default_rng(s).random() > 0.5))
                for x, y in zip(a, b):
                    assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
                    np.testing.assert_array_equal(x, y)
        assert flips == {True, False}
        img, thumb = ours.__getitem__(0, np.random.default_rng(0))
        assert img.shape == (32, 32, 3) and thumb.shape == (16, 16, 3)
        with pytest.raises(KeyError):
            ours.__getitem__(6, np.random.default_rng(0))
    finally:
        ours.close()
        ref.close()


def _batches(loader_cls, ds, n, **kw):
    with loader_cls(ds, batch_size=4, seed=1, **kw) as loader:
        it = iter(loader)
        return [next(it) for _ in range(n)]


@pytest.mark.parametrize("hosts", [(0, 1), (0, 2), (1, 2)])
def test_loader_batches_equal_the_jax_loader(store, hosts):
    """Five batches of 4 from 6 images: drop-last gives one batch an epoch,
    so the run crosses four epoch boundaries; with two hosts each yields
    its half of every global batch."""
    host_id, num_hosts = hosts
    ours, ref = MultiResolutionDataset(store, 32, 16), JDataset(store, 32, 16)
    try:
        a = _batches(DataLoader, ours, 5, host_id=host_id, num_hosts=num_hosts)
        b = _batches(JDataLoader, ref, 5, host_id=host_id, num_hosts=num_hosts)
        for (ai, at), (bi, bt) in zip(a, b):
            assert ai.shape == (4 // num_hosts, 32, 32, 3) and at.shape == (4 // num_hosts, 16, 16, 3)
            np.testing.assert_array_equal(ai, bi)
            np.testing.assert_array_equal(at, bt)
    finally:
        ours.close()
        ref.close()
    with pytest.raises(ValueError):
        DataLoader(ours, batch_size=5, num_hosts=2)


def test_loader_worker_death_raises_at_the_consumer_and_close_joins(store):
    ds = MultiResolutionDataset(store, 32, 16)
    ds.close()  # every read now raises in the worker
    loader = DataLoader(ds, batch_size=2, seed=0)
    with pytest.raises(RuntimeError, match="worker died") as exc:
        next(iter(loader))
    assert isinstance(exc.value.__cause__, ValueError)

    ds = MultiResolutionDataset(store, 32, 16)
    loader = DataLoader(ds, batch_size=2, seed=0, prefetch=1)
    it = iter(loader)
    next(it)
    threads = [t for _, t in loader._workers]
    assert len(threads) == 1 and threads[0].is_alive()
    loader.close()
    assert not threads[0].is_alive() and loader._workers == []
    loader.close()  # idempotent
    ds.close()


def test_prepare_matches_the_jax_prepare(tmp_path):
    """Non-square PNGs (wider, taller, square) at sizes (16, 32): the same
    keys and length, and records that decode to the same pixels; the port
    through its process pool and serially."""
    d = _image_dir(tmp_path, [(30, 44), (52, 36), (37, 37), (21, 64)], seed=5)
    paths = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port"),
             "port_serial": str(tmp_path / "port_serial")}
    assert j_prepare(str(d), paths["jax"], sizes=(16, 32), n_workers=1) == 4
    assert prepare_data(str(d), paths["port"], sizes=(16, 32), n_workers=2) == 4
    assert prepare_data(str(d), paths["port_serial"], sizes=(16, 32), n_workers=1) == 4
    with JReader(paths["jax"]) as ref:
        keys = list(ref.keys())
        assert keys[-1] == "length" and ref.get("length") == b"4"
        for name in ("port", "port_serial"):
            with RecordReader(paths[name]) as r:
                assert list(r.keys()) == keys and r.get("length") == b"4"
                for k in keys[:-1]:
                    np.testing.assert_array_equal(png.decode_png(r.get(k)),
                                                  _pil_rgb(ref.get(k)), err_msg=k)
    assert list_images(str(d)) == sorted(str(p) for p in d.iterdir())


def test_prepare_reads_npy_and_refuses_other_formats_before_writing(tmp_path):
    """``.npy`` input is stored only on request (``npy=True``) and then gives
    the PNG's records; a JPEG is read (as PIL decodes it), a progressive one
    too, and a 12-bit JPEG, which PIL refuses too, raises before anything is
    written."""
    d = _image_dir(tmp_path, [(30, 44)])
    arr = np.asarray(Image.open(d / "000.png"))
    npy = tmp_path / "npy"
    npy.mkdir()
    np.save(npy / "000.npy", arr)
    assert prepare_data(str(d), str(tmp_path / "png"), sizes=(16,), n_workers=1) == 1
    assert prepare_data(str(npy), str(tmp_path / "npy_out"), sizes=(16,), n_workers=1,
                        npy=True) == 1
    with RecordReader(str(tmp_path / "png")) as a, RecordReader(str(tmp_path / "npy_out")) as b:
        np.testing.assert_array_equal(png.decode_png(a.get("16-00000")),
                                      png.decode_png(b.get("16-00000")))
    Image.fromarray(arr).save(d / "001.jpg")
    assert prepare_data(str(d), str(tmp_path / "jpg"), sizes=(16,), n_workers=1) == 2
    assert j_prepare(str(d), str(tmp_path / "jpg_jax"), sizes=(16,), n_workers=1) == 2
    with RecordReader(str(tmp_path / "jpg")) as a, JReader(str(tmp_path / "jpg_jax")) as b:
        np.testing.assert_array_equal(png.decode_png(a.get("16-00001")),
                                      _pil_rgb(b.get("16-00001")))
    Image.fromarray(arr).save(d / "002.jpg", progressive=True)
    assert prepare_data(str(d), str(tmp_path / "progressive"), sizes=(16,), n_workers=1) == 3
    assert j_prepare(str(d), str(tmp_path / "progressive_jax"), sizes=(16,), n_workers=1) == 3
    with RecordReader(str(tmp_path / "progressive")) as a, \
            JReader(str(tmp_path / "progressive_jax")) as b:
        np.testing.assert_array_equal(png.decode_png(a.get("16-00002")),
                                      _pil_rgb(b.get("16-00002")))
    twelve_bit = bytearray((d / "001.jpg").read_bytes())
    twelve_bit[twelve_bit.index(b"\xff\xc0") + 4] = 12  # the frame's precision
    (d / "003.jpg").write_bytes(bytes(twelve_bit))
    with pytest.raises(ValueError, match="003.jpg: 12-bit JPEG is not read by the port, nor by "
                                         "PIL"):
        prepare_data(str(d), str(tmp_path / "twelve_bit"), sizes=(16,), n_workers=1)
    assert not os.path.exists(tmp_path / "twelve_bit")


def _mixed_dir(tmp_path):
    """``a.png``, ``b.npy``, ``c.png`` (40², random): the folder on which the
    two packages once wrote different stores."""
    d = tmp_path / "mixed"
    d.mkdir()
    rng = np.random.default_rng(11)
    arrs = [rng.integers(0, 256, (40, 40, 3), dtype=np.uint8) for _ in range(3)]
    Image.fromarray(arrs[0]).save(d / "a.png")
    np.save(d / "b.npy", arrs[1])
    Image.fromarray(arrs[2]).save(d / "c.png")
    return d, arrs


def test_prepare_lists_a_mixed_folder_as_the_jax_prepare(tmp_path):
    """By default the port skips ``.npy`` files as the JAX package does:
    the same record count and the same bytes under every key."""
    d, _ = _mixed_dir(tmp_path)
    assert j_prepare(str(d), str(tmp_path / "jax"), sizes=(16,), n_workers=1) == 2
    assert prepare_data(str(d), str(tmp_path / "port"), sizes=(16,), n_workers=1) == 2
    assert list_images(str(d)) == [str(d / "a.png"), str(d / "c.png")]
    with JReader(str(tmp_path / "jax")) as ref, RecordReader(str(tmp_path / "port")) as r:
        keys = list(ref.keys())
        assert keys == ["16-00000", "16-00001", "length"] and list(r.keys()) == keys
        assert r.get("length") == ref.get("length") == b"2"
        for k in keys[:-1]:
            np.testing.assert_array_equal(png.decode_png(r.get(k)), _pil_rgb(ref.get(k)),
                                          err_msg=k)


def test_prepare_stores_npy_on_request(tmp_path):
    """``npy=True`` (``--npy`` on the command line) takes the folder's
    ``.npy`` array in its sorted place."""
    from sdface_gan_tpu_torch import prepare_data as prepare_cli

    d, arrs = _mixed_dir(tmp_path)
    assert list_images(str(d), npy=True) == [str(d / n) for n in ("a.png", "b.npy", "c.png")]
    prepare_cli.main([str(d), "--out", str(tmp_path / "cli"), "--size", "40", "--n_worker",
                      "1", "--npy"])
    with RecordReader(str(tmp_path / "cli")) as r:
        assert r.get("length") == b"3"
        for i, arr in enumerate(arrs):  # 40² at 40: LANCZOS leaves the pixels as they are
            np.testing.assert_array_equal(png.decode_png(r.get(f"40-{i:05d}")), arr)


def test_real_dir_refuses_npy(tmp_path):
    """``evaluation/real.py`` reads a ``--real_dir`` as the JAX eval opens it
    with PIL: a ``.npy`` file raises before any work (only ``prepare_data``
    takes ``.npy`` input, on request); the folder's PNGs read as PIL reads
    them."""
    from sdface_gan_tpu_torch.evaluation.real import dir_batches, list_image_files

    d, arrs = _mixed_dir(tmp_path)
    with pytest.raises(ValueError, match=r"\.npy input is read only by prepare_data"):
        list_image_files(str(d))
    with pytest.raises(ValueError, match=r"\.npy input is read only by prepare_data"):
        next(dir_batches(str(d), ["b.npy"], 1))
    os.remove(d / "b.npy")
    names = list_image_files(str(d))
    assert names == ["a.png", "c.png"]
    got = np.concatenate(list(dir_batches(str(d), names, 2)))
    np.testing.assert_array_equal(got, np.stack(arrs[::2]).astype(np.float32) / 127.5 - 1.0)
