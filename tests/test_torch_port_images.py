"""The port's image decoders against PIL, on the CPU.

PIL writes (or, where PIL writes no such file, the functions here write)
the bytes; ``PIL.Image.open(...).convert("RGB")`` and the port's
``data.decode.decode_image`` read them; the two must be equal byte for
byte.  PIL 12 with libjpeg-turbo is the reference the JAX package reads
images with.  Kinds the port does not read raise ``ValueError`` naming
ROADMAP.md.  The committed fixtures (``tests/fixtures/images/``) are held
against the PIL decodes committed beside them, as the card's machine,
which has no PIL, holds them.
"""

import io
import os
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from sdface_gan_tpu.data import prepare_data as j_prepare
from sdface_gan_tpu.native import RecordReader as JReader
from sdface_gan_tpu_torch.data import png, prepare_data
from sdface_gan_tpu_torch.data.decode import check_image, decode_image
from sdface_gan_tpu_torch.native import RecordReader

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _smooth(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Smooth colour waves plus a little noise: what a photo's blocks hold."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    f = rng.uniform(0.05, 0.3, (3, 2))
    img = np.stack([128 + 90 * np.sin(f[c, 0] * xx + c) * np.cos(f[c, 1] * yy - c)
                    for c in range(3)], -1) + rng.normal(0, 6, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


# ------------------------------------------------------- hand-built files
def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
PNG_KINDS = [(ctype, depth) for ctype, depths in
             ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16)))
             for depth in depths]


def _packed_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, c] samples -> [h, stride] bytes of one PNG image (or pass)."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.int64)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per))).reshape(h, -1, per)
    return (flat << np.arange(8 - depth, -1, -depth)).sum(-1).astype(np.uint8)


def _filtered(rows: np.ndarray, bpp: int, first_type: int) -> bytes:
    """PNG filtering, row y by type (first_type + y) % 5 (Paeth included)."""
    x = rows.astype(np.int64)
    out = []
    for y in range(x.shape[0]):
        t = (first_type + y) % 5
        up = x[y - 1] if y else np.zeros_like(x[y])
        left = np.concatenate([np.zeros(bpp, np.int64), x[y][:-bpp]])[:len(x[y])]
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])[:len(up)]
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        pred = (np.zeros_like(left), left, up, (left + up) // 2, paeth)[t]
        out.append(bytes([t]) + ((x[y] - pred) % 256).astype(np.uint8).tobytes())
    return b"".join(out)


def png_bytes(samples: np.ndarray, ctype: int, depth: int, interlace: int,
              plte: bytes = None) -> bytes:
    """A PNG of ``samples`` [h, w, c] (raw sample values) built by hand:
    every filter type in turn, Adam7 passes when ``interlace``."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        parts = [samples[y0::dy, x0::dx] for x0, y0, dx, dy in _ADAM7]
        raw = b"".join(_filtered(_packed_rows(p, depth), bpp, i)
                       for i, p in enumerate(parts) if p.size)
    else:
        raw = _filtered(_packed_rows(samples, depth), bpp, 0)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return (png.SIGNATURE + _chunk(b"IHDR", ihdr) + (_chunk(b"PLTE", plte) if plte else b"")
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def png_samples(rng, h: int, w: int, ctype: int, depth: int):
    """Random samples for a colour type and depth, and a palette for type 3
    (shorter than the indices reach, so that missing entries are read)."""
    s = rng.integers(0, 1 << depth, (h, w, _CHANNELS[ctype]))
    if ctype == 0 and depth == 16:  # PIL clips grey16 to 255: hit both sides
        s.flat[:3] = (256, 1000, 100)[:s.size]
    plte = None
    if ctype == 3:
        plte = rng.integers(0, 256, 3 * max(1, (1 << depth) - 1), dtype=np.uint8).tobytes()
    return s, plte


def bmp_bytes(values: np.ndarray, bits: int, palette: np.ndarray = None,
              top_down: bool = False) -> bytes:
    """An uncompressed (BI_RGB) BMP with a 40-byte header: ``values`` are
    palette indices [h, w] (1, 4, 8 bits) or RGB [h, w, 3] (24, 32 bits)."""
    h, w = values.shape[:2]
    stride = (bits * w + 31) // 32 * 4
    rows = []
    for r in (values if top_down else values[::-1]):
        if bits == 24:
            b = r[:, ::-1].astype(np.uint8).tobytes()
        elif bits == 32:
            b = np.concatenate([r[:, ::-1], np.full((w, 1), 9)], 1).astype(np.uint8).tobytes()
        else:
            b = _packed_rows(r[None, :, None], bits).tobytes()
        rows.append(b + bytes(stride - len(b)))
    pal = b"" if palette is None else b"".join(bytes([p[2], p[1], p[0], 0]) for p in palette)
    dib = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits, 0, stride * h,
                      2835, 2835, 0 if palette is None else len(palette), 0)
    body = dib + pal + b"".join(rows)
    return b"BM" + struct.pack("<IHHI", 14 + len(body), 0, 0, 14 + len(dib) + len(pal)) + body


def adobe_rgb(jpeg: bytes) -> bytes:
    """The JPEG with its JFIF APP0 replaced by an Adobe APP14 of transform 0:
    libjpeg then takes the three components as R, G, B."""
    assert jpeg[2:4] == b"\xff\xe0"
    app0_end = 4 + struct.unpack(">H", jpeg[4:6])[0]
    app14 = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0)
    return jpeg[:2] + b"\xff\xee" + struct.pack(">H", 2 + len(app14)) + app14 + jpeg[app0_end:]


def _jpeg(img: np.ndarray, tmp_path=None, **kw) -> bytes:
    if tmp_path is None:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", **kw)
        return buf.getvalue()
    path = tmp_path / "x.jpg"  # optimize=True needs a real file at large sizes
    Image.fromarray(img).save(path, "JPEG", **kw)
    return path.read_bytes()


# ------------------------------------------------------------------- JPEG
@pytest.mark.parametrize("size", [(1, 1), (7, 9), (17, 33), (218, 178)])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_jpeg_matches_pil(quality, subsampling, size):
    """4:4:4 / 4:2:2 / 4:2:0 at four qualities and sizes with odd edges
    (178 x 218: CelebA's aligned faces), smooth and noisy."""
    for img in (_smooth(*size, seed=quality), np.random.default_rng(size[0]).integers(
            0, 256, (*size, 3), dtype=np.uint8)):
        data = _jpeg(img, quality=quality, subsampling=subsampling)
        np.testing.assert_array_equal(decode_image(data), _pil(data))


@pytest.mark.parametrize("case", ["grey", "optimize", "restart_blocks", "restart_rows",
                                  "adobe_rgb"])
def test_jpeg_variants_match_pil(case, tmp_path):
    """Grey, optimised Huffman tables, restart intervals, and a 3-component
    file that an Adobe marker declares RGB."""
    for size in ((7, 9), (218, 178)):
        img = _smooth(*size, seed=3)
        if case == "grey":
            data = _jpeg(img[..., 1], quality=90)
        elif case == "optimize":
            data = _jpeg(img, tmp_path, quality=85, optimize=True)
        elif case == "restart_blocks":
            data = _jpeg(img, quality=90, restart_marker_blocks=3)
        elif case == "restart_rows":
            data = _jpeg(img, quality=90, subsampling=1, restart_marker_rows=1)
        else:
            data = adobe_rgb(_jpeg(img, quality=90, subsampling=0))
        np.testing.assert_array_equal(decode_image(data), _pil(data))


def _sof_patched(data: bytes, sof: int = None, precision: int = None) -> bytes:
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if sof is not None:
        out[i + 1] = sof
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def test_refused_kinds_raise_naming_roadmap():
    img = _smooth(16, 16)
    baseline = _jpeg(img, quality=90)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", progressive=True)
    webp = io.BytesIO()
    Image.fromarray(img).save(webp, "WEBP")
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    rle = bytearray(bmp_bytes(np.zeros((4, 4), np.int64), 8, np.zeros((2, 3), np.int64)))
    rle[30:34] = struct.pack("<I", 1)  # BI_RLE8
    rgb16 = bytearray(bmp_bytes(np.zeros((4, 4, 3), np.int64), 24))
    rgb16[28:30] = struct.pack("<H", 16)
    cases = {"progressive": buf.getvalue(), "WebP": webp.getvalue(), "CMYK": cmyk.getvalue(),
             "arithmetic": _sof_patched(baseline, sof=0xC9),
             "lossless": _sof_patched(baseline, sof=0xC3),
             "12-bit": _sof_patched(baseline, precision=12), "RLE8": bytes(rle),
             "16-bit BMP": bytes(rgb16)}
    for what, data in cases.items():
        for fn in (decode_image, check_image):
            with pytest.raises(ValueError, match="ROADMAP") as e:
                fn(data)
            assert what.split()[0] in str(e.value), (what, str(e.value))


def test_truncated_and_corrupt_files_raise():
    data = _jpeg(_smooth(40, 40), quality=90)
    for bad in (data[:3], data[:len(data) // 2], data[:-2] + b"\xff\xd8"):
        with pytest.raises(ValueError, match="truncated|corrupt"):
            decode_image(bad)
    with pytest.raises(ValueError, match="not an image"):
        decode_image(b"GIF89a" + bytes(30))
    s, _ = png_samples(np.random.default_rng(0), 5, 4, 2, 8)
    interlaced = png_bytes(s, 2, 8, 1)
    z = zlib.compress(zlib.decompress(png.parse(interlaced)[1][0])[:-5])
    short = interlaced[:interlaced.index(b"IDAT") - 4] + _chunk(b"IDAT", z) + _chunk(b"IEND", b"")
    with pytest.raises(ValueError, match="too short"):
        decode_image(short)
    bmp = bmp_bytes(np.zeros((6, 5, 3), np.int64), 24)
    with pytest.raises(ValueError, match="truncated"):
        decode_image(bmp[:-10])


# -------------------------------------------------------------------- PNG
@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype,depth", PNG_KINDS)
def test_png_matches_pil(ctype, depth, interlace):
    """Every colour type at every bit depth PNG allows, plain and Adam7, at
    sizes that leave passes empty or ragged; grey16 clipped, the other
    16-bit kinds by their high byte, a palette's missing entries black."""
    rng = np.random.default_rng(10 * ctype + depth + interlace)
    for h, w in ((1, 1), (3, 5), (9, 17), (20, 13)):
        s, plte = png_samples(rng, h, w, ctype, depth)
        data = png_bytes(s, ctype, depth, interlace, plte)
        np.testing.assert_array_equal(decode_image(data), _pil(data), err_msg=f"{h}x{w}")


@pytest.mark.parametrize("mode", ["P", "1", "L", "LA", "I;16"])
def test_pil_written_png_matches_pil(mode):
    img = Image.fromarray(_smooth(23, 31))
    img = img.convert(mode) if mode != "I;16" else Image.fromarray(
        (np.asarray(img)[..., 0].astype(np.uint16) * 3))
    buf = io.BytesIO()
    img.save(buf, "PNG")
    np.testing.assert_array_equal(decode_image(buf.getvalue()), _pil(buf.getvalue()))


# -------------------------------------------------------------------- BMP
@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("bits", [1, 4, 8, 24, 32])
def test_bmp_matches_pil(bits, top_down):
    """Palette images (a palette shorter than the indices reach) and BGR(X)
    ones, bottom-up and top-down, rows padded to 4 bytes."""
    rng = np.random.default_rng(bits)
    for h, w in ((1, 1), (3, 5), (9, 17), (20, 13)):
        if bits <= 8:
            pal = rng.integers(0, 256, (max(2, (1 << bits) - 1), 3))
            data = bmp_bytes(rng.integers(0, 1 << bits, (h, w)), bits, pal, top_down)
        else:
            data = bmp_bytes(rng.integers(0, 256, (h, w, 3)), bits, None, top_down)
        np.testing.assert_array_equal(decode_image(data), _pil(data), err_msg=f"{h}x{w}")


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_pil_written_bmp_matches_pil(mode):
    buf = io.BytesIO()
    Image.fromarray(_smooth(19, 26)).convert(mode).save(buf, "BMP")
    np.testing.assert_array_equal(decode_image(buf.getvalue()), _pil(buf.getvalue()))


# --------------------------------------------------------------- fixtures
def _fixture_names():
    return sorted(p.name for p in FIXTURES.iterdir() if p.suffix != ".npy"
                  and p.suffix != ".py")


def test_committed_fixtures_decode_to_their_pil_decodes():
    """Each committed image equals PIL's decode of it now and the ``.npy``
    committed beside it (the card's machine checks against the latter)."""
    names = _fixture_names()
    assert sum(n.endswith(".jpg") for n in names) >= 6 and len(names) >= 10
    for name in names:
        data = (FIXTURES / name).read_bytes()
        want = np.load(FIXTURES / (name + ".npy"))
        np.testing.assert_array_equal(_pil(data), want, err_msg=name)
        np.testing.assert_array_equal(decode_image(data), want, err_msg=name)


# ---------------------------------------------------- prepare and scoring
def _mixed_folder(d: Path) -> None:
    d.mkdir()
    for i, ss in enumerate((0, 1, 2)):
        Image.fromarray(_smooth(37 + 4 * i, 30, seed=i)).save(d / f"{i:02d}.jpg", quality=88,
                                                              subsampling=ss)
    (d / "03.bmp").write_bytes(bmp_bytes(_smooth(26, 35, seed=4).astype(np.int64), 24))
    s, plte = png_samples(np.random.default_rng(5), 33, 28, 3, 4)
    (d / "04.png").write_bytes(png_bytes(s, 3, 4, 1, plte))
    (d / "05.jpeg").write_bytes(_jpeg(_smooth(31, 31, seed=6)[..., 0], quality=70))


def test_prepare_on_jpeg_bmp_and_png_writes_the_jax_store(tmp_path):
    """The port's ``prepare_data`` on a folder of JPEG, BMP and palette /
    interlaced PNG files: every record decodes to the JAX ``prepare_data``'s
    (which opens the files with PIL)."""
    d = tmp_path / "imgs"
    _mixed_folder(d)
    assert j_prepare(str(d), str(tmp_path / "jax"), sizes=(16, 24), n_workers=1) == 6
    assert prepare_data(str(d), str(tmp_path / "port"), sizes=(16, 24), n_workers=2) == 6
    with JReader(str(tmp_path / "jax")) as ref, RecordReader(str(tmp_path / "port")) as ours:
        keys = list(ref.keys())
        assert list(ours.keys()) == keys and len(keys) == 13
        for k in keys[:-1]:
            np.testing.assert_array_equal(png.decode_png(ours.get(k)), _pil(ref.get(k)),
                                          err_msg=k)


def test_prepare_refuses_webp_before_writing(tmp_path):
    d = tmp_path / "imgs"
    _mixed_folder(d)
    Image.fromarray(_smooth(20, 20)).save(d / "06.webp", "WEBP")
    with pytest.raises(ValueError, match="06.webp: WebP .*ROADMAP"):
        prepare_data(str(d), str(tmp_path / "out"), sizes=(16,), n_workers=1)
    assert not (tmp_path / "out").exists()


def test_calc_fid_stats_reads_a_jpeg_folder_as_pil_decodes_it(tmp_path, monkeypatch):
    """``calc_fid_stats`` on JPEG, BMP and PNG files gives the statistics of
    the same images stored as PIL's decodes (random Inception weights)."""
    import torch

    from sdface_gan_tpu_torch import calc_fid_stats as calc_cli
    from sdface_gan_tpu_torch.evaluation.inception import InceptionV3

    d = tmp_path / "imgs"
    _mixed_folder(d)
    decoded = tmp_path / "decoded"
    decoded.mkdir()
    for n in sorted(os.listdir(d)):
        Image.open(d / n).convert("RGB").save(decoded / f"{n}.png")
    torch.manual_seed(0)
    torch.save(InceptionV3(device="cpu").state_dict(), tmp_path / "inception.pth")
    monkeypatch.chdir(tmp_path)
    args = ["--img_size", "24", "--batch", "4", "--inception_weights", "inception.pth",
            "--device", "cpu"]
    assert calc_cli.main(["imgs", "--out", "a.npz", *args]) == 6
    assert calc_cli.main(["decoded", "--out", "b.npz", *args]) == 6
    with np.load("a.npz") as a, np.load("b.npz") as b:
        np.testing.assert_array_equal(a["mu"], b["mu"])
        np.testing.assert_array_equal(a["sigma"], b["sigma"])
