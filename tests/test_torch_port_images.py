"""The port's image decoders against PIL, on the CPU.

PIL writes (or, where PIL writes no such file, the functions here write)
the bytes; ``PIL.Image.open(...).convert("RGB")`` and the port's
``data.decode.decode_image`` read them; the two must be equal byte for
byte.  PIL 12 with libjpeg-turbo and libwebp is the reference the JAX
package reads images with.  Kinds the port does not read raise
``ValueError`` naming ROADMAP.md, or saying that PIL does not read them
either.  The committed fixtures (``tests/fixtures/images/``) are held
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
# committed fixtures of the WebP and BMP kinds (make_image_fixtures.py);
# the files libwebp's advanced encoder wrote, with the header field each holds
WEBP_ENCODER_FIXTURES = {"webp_simple_filter.webp": ("simple", 1),
                         "webp_partitions4.webp": ("partitions", 4),
                         "webp_partitions8.webp": ("partitions", 8),
                         "webp_one_segment.webp": ("segments", 0),
                         "webp_sharpness7.webp": ("sharpness", 7),
                         "webp_no_filter.webp": ("level", 0)}
WEBP_FIXTURES = ["webp_lossy.webp", "webp_lossless.webp", "webp_alpha.webp",
                 "webp_extended.webp", "webp_lossy_512.webp", "webp_lossless_512.webp",
                 "webp_anim_lossy.webp", "webp_anim_lossless_offset.webp",
                 "webp_anim_alpha.webp", "webp_anim_pil.webp", *WEBP_ENCODER_FIXTURES]
BMP_FIXTURES = ["bmp_rle8.bmp", "bmp_rle4.bmp", "bmp_bitfields565.bmp", "bmp_rgb555.bmp",
                "bmp_bitfields_alpha.bmp"]


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


def _bmp_file(w: int, h: int, bits: int, compression: int, pixels: bytes,
              palette: np.ndarray = None, masks=None, header: int = 40) -> bytes:
    """A BMP with a ``header``-byte DIB header: bit-field ``masks`` inside a
    header of 52 bytes or more (the alpha mask from 56), after a 40-byte
    one; a negative ``h`` is top-down."""
    dib = struct.pack("<IiiHHIIiiII", header, w, h, 1, bits, compression, len(pixels), 2835,
                      2835, 0 if palette is None else len(palette), 0)
    extra = b""
    if masks is not None and header == 40:
        extra = struct.pack("<III", *masks[:3])
    elif header > 40:
        dib += struct.pack("<IIII", *(tuple(masks or ()) + (0, 0, 0, 0))[:4])[:header - 40]
        dib = dib.ljust(header, b"\0")
    pal = b"" if palette is None else b"".join(bytes([p[2], p[1], p[0], 0]) for p in palette)
    body = dib + extra + pal + pixels
    return (b"BM" + struct.pack("<IHHI", 14 + len(body), 0, 0, 14 + len(dib) + len(extra)
                                + len(pal)) + body)


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
    return _bmp_file(w, -h if top_down else h, bits, 0, b"".join(rows), palette)


def rle_commands(index: np.ndarray, rle4: bool, odd_runs: bool = False) -> bytes:
    """Run-length commands for rows of palette indices [h, w], first row
    first: encoded runs of equal pixels, absolute runs of 3 or more
    others (RLE4: of even length unless ``odd_runs``, whose runs of 4k + 3
    PIL reads short by one pixel), an end of line after each row and an
    end of bitmap."""
    out = bytearray()
    for row in index:
        x, w = 0, len(row)
        while x < w:
            n = 1
            while x + n < w and n < 255 and row[x + n] == row[x]:
                n += 1
            if n >= 2 or w - x < 3:
                out += bytes([n, int(row[x]) * 17 if rle4 else int(row[x])])
                x += n
                continue
            n = 3
            while x + n < w and n < 254 and row[x + n] != row[x + n - 1]:
                n += 1
            if rle4 and n % 2 and not (odd_runs and n % 4 == 3):
                n -= 1
            if n < 3:
                out += bytes([1, int(row[x]) * 17 if rle4 else int(row[x])])
                x += 1
                continue
            vals = [int(v) for v in row[x:x + n]]
            data = (bytes(vals) if not rle4 else
                    bytes((vals[i] << 4) | (vals[i + 1] if i + 1 < n else 0)
                          for i in range(0, n, 2)))
            out += bytes([0, n]) + data + bytes(len(data) % 2)
            x += n
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp_rle_bytes(index: np.ndarray, rle4: bool, palette: np.ndarray, commands: bytes = None,
                  top_down: bool = False, bits: int = None) -> bytes:
    """An RLE8 / RLE4 BMP of palette indices [h, w] (bottom-up unless
    ``top_down``), encoded by :func:`rle_commands` or given as ``commands``."""
    h, w = index.shape
    if commands is None:
        commands = rle_commands(index if top_down else index[::-1], rle4)
    return _bmp_file(w, -h if top_down else h, bits or (4 if rle4 else 8), 2 if rle4 else 1,
                     commands, palette)


def bmp_bitfield_bytes(rgb: np.ndarray, bits: int, masks, header: int = 40,
                       compression: int = 3) -> bytes:
    """A bit-field (or, with ``compression`` 0, plain) 16-, 24- or 32-bit BMP
    of RGB [h, w, 3]; each channel is placed under its mask (a 32-bit alpha
    channel gets 7)."""
    h, w = rgb.shape[:2]
    v = np.zeros((h, w), np.uint64)
    chans = [rgb[..., c].astype(np.uint64) for c in range(3)] + [np.full((h, w), 7, np.uint64)]
    for m, c in zip(tuple(masks) + (0,) * (4 - len(masks)), chans):
        if m:
            shift = (m & -m).bit_length() - 1
            width = bin(m).count("1")
            v |= ((c >> np.uint64(8 - width)) if width < 8 else c) << np.uint64(shift)
    stride = (bits * w + 31) // 32 * 4
    raw = v.astype("<u4").view(np.uint8).reshape(h, w, 4)[..., :bits // 8].reshape(h, -1)
    rows = b"".join(r.tobytes().ljust(stride, b"\0") for r in raw[::-1])
    return _bmp_file(w, h, bits, compression, rows, masks=masks if compression else None,
                     header=header)


class _BoolReader:
    """RFC 6386's boolean decoder, enough to read a VP8 frame header."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.value, self.bits, self.range = data, 0, 0, -8, 254
        self._load()

    def _load(self):
        byte = self.data[self.pos] if self.pos < len(self.data) else 0
        self.pos += 1
        self.value, self.bits = (self.value << 8) | byte, self.bits + 8

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        split = (self.range * prob) >> 8
        if (self.value >> self.bits) > split:
            rng, self.value, b = self.range - split, self.value - ((split + 1) << self.bits), 1
        else:
            rng, b = split + 1, 0
        shift = 8 - rng.bit_length()
        self.range, self.bits = (rng << shift) - 1, self.bits - shift
        return b

    def value_of(self, n: int, signed: bool = False) -> int:
        v = 0
        for i in range(n - 1, -1, -1):
            v |= self.bit(128) << i
        return -v if signed and self.bit(128) else v


def vp8_header_fields(data: bytes) -> dict:
    """A lossy WebP's segment count (0: segmentation off), loop filter
    (simple, level, sharpness) and token partitions, from its first
    partition."""
    at = data.index(b"VP8 ") + 8
    part0 = int.from_bytes(data[at:at + 3], "little") >> 5
    br = _BoolReader(data[at + 10:at + 10 + part0])
    br.value_of(2)  # colour space, clamping
    segments = 0
    if br.value_of(1):
        segments, update_map = 4, br.value_of(1)
        if br.value_of(1):
            br.value_of(1)
            for bits in (7,) * 4 + (6,) * 4:
                if br.value_of(1):
                    br.value_of(bits, signed=True)
        if update_map:
            for _ in range(3):
                if br.value_of(1):
                    br.value_of(8)
    simple, level, sharpness = br.value_of(1), br.value_of(6), br.value_of(3)
    if br.value_of(1) and br.value_of(1):
        for _ in range(8):
            if br.value_of(1):
                br.value_of(6, signed=True)
    return dict(segments=segments, simple=simple, level=level, sharpness=sharpness,
                partitions=1 << br.value_of(2))


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


def _webp(img, **kw) -> bytes:
    buf = io.BytesIO()
    (img if isinstance(img, Image.Image) else Image.fromarray(img)).save(buf, "WEBP", **kw)
    return buf.getvalue()


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


def animated_webp(n_frames: int = 2) -> bytes:
    frames = [Image.fromarray(_smooth(16, 16, seed=i)) for i in range(n_frames)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=50)
    return buf.getvalue()


def _riff_chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def animated_webp_bytes(canvas, frames, alpha: bool = False) -> bytes:
    """An animated WebP assembled by hand (PIL's save writes no such
    layout): a ``canvas`` of (width, height) and ``frames`` of (a still
    WebP whose image chunks the frame takes, x, y, ANMF flags), x and y
    even.  The flags' bit 1 asks for no blending, bit 0 for disposal."""
    le24 = lambda v: struct.pack("<I", v)[:3]  # noqa: E731
    body = _riff_chunk(b"VP8X", bytes([0x02 | (0x10 if alpha else 0), 0, 0, 0])
                       + le24(canvas[0] - 1) + le24(canvas[1] - 1))
    body += _riff_chunk(b"ANIM", struct.pack("<IH", 0xFF204080, 0))
    for still, x, y, flags in frames:
        chunks = still[12:]
        if chunks[:4] == b"VP8X":  # the ALPH and VP8 chunks of an extended file
            chunks = chunks[18:]
        w, h = Image.open(io.BytesIO(still)).size
        body += _riff_chunk(b"ANMF", le24(x // 2) + le24(y // 2) + le24(w - 1) + le24(h - 1)
                            + le24(80) + bytes([flags]) + chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def test_refused_kinds_raise_naming_roadmap():
    """The kinds that raised naming ROADMAP.md's item 4 (progressive,
    arithmetic-coded, lossless and CMYK JPEG, animated WebP) are now read as
    PIL reads them, so no file names a ROADMAP gap any more: what the port
    still refuses, PIL refuses too, and the message says so (a 12-bit JPEG
    here; the other kinds in ``test_torch_port_images_jpeg.py``)."""
    img = _smooth(16, 16)
    baseline = _jpeg(img, quality=90)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", progressive=True)
    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    for data in (buf.getvalue(), animated_webp(), cmyk.getvalue()):
        check_image(data)
        np.testing.assert_array_equal(decode_image(data), _pil(data))
    twelve_bit = _sof_patched(baseline, precision=12)
    with pytest.raises(OSError):  # PIL: "cannot handle 12-bit layers"
        _pil(twelve_bit)
    for fn in (decode_image, check_image):
        with pytest.raises(ValueError, match="12-bit JPEG is not read by the port, nor by PIL") \
                as e:
            fn(twelve_bit)
        assert "ROADMAP" not in str(e.value)


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


# ------------------------------------------------------------------- WebP
WEBP_SIZES = ((1, 1), (7, 9), (17, 33), (218, 178))


def _two_images(size, seed):
    """A smooth image and uniform noise: few and many coefficients."""
    return (_smooth(*size, seed=seed),
            np.random.default_rng(seed).integers(0, 256, (*size, 3), dtype=np.uint8))


@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("quality", [0, 50, 80, 100])
def test_webp_lossy_matches_pil(quality, method):
    """Lossy VP8 at four qualities and three methods, at sizes that are not
    multiples of 16 (or of 2): the upsampler's edges, the 4x4 blocks'
    top-right pixels, the loop filter's order and per-segment levels; and
    at 512^2."""
    for size in WEBP_SIZES + ((512, 512),):
        for img in _two_images(size, quality + method):
            data = _webp(img, quality=quality, method=method)
            assert data[12:16] == b"VP8 "
            np.testing.assert_array_equal(decode_image(data), _pil(data), err_msg=f"{size}")


def _alpha(size, seed):
    """Real alpha: transparent top half, noise below."""
    a = np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8)
    a[:size[0] // 2] = 0
    return a


@pytest.mark.parametrize("case", ["grey", "rgba", "rgba_alpha_q50", "exif", "icc", "512"])
def test_webp_lossy_variants_match_pil(case):
    """``L`` images, RGBA with real alpha (``VP8X`` + ``ALPH``, also at
    ``alpha_quality=50``), ``EXIF`` and ``ICCP`` chunks, and a smooth 512^2
    image at PIL's default settings."""
    sizes = ((512, 512),) if case == "512" else WEBP_SIZES
    for size in sizes:
        img = _smooth(*size, seed=11)
        if case == "grey":
            data = _webp(img[..., 1], quality=70)
        elif case.startswith("rgba"):
            aq = 50 if case.endswith("q50") else 100
            data = _webp(np.dstack([img, _alpha(size, 3)]), quality=80, alpha_quality=aq)
            assert data[12:16] == b"VP8X" and b"ALPH" in data
        elif case == "exif":
            data = _webp(img, quality=70, exif=b"Exif\0\0II*\0\x08\0\0\0\0\0")
            assert b"EXIF" in data
        elif case == "icc":
            data = _webp(img, quality=70, icc_profile=bytes(range(131)))
            assert b"ICCP" in data
        else:
            data = _webp(img, quality=80)
        np.testing.assert_array_equal(decode_image(data), _pil(data), err_msg=f"{size}")


@pytest.mark.parametrize("quality", [0, 100])
@pytest.mark.parametrize("method", [0, 6])
def test_webp_lossless_matches_pil(method, quality):
    """Lossless VP8L at the fastest and slowest settings: the predictor
    (its top row and left column), cross-colour and subtract-green
    transforms, the colour cache, meta prefix codes and back-references,
    up to 512^2."""
    for size in WEBP_SIZES + ((64, 200), (512, 512)):
        for img in _two_images(size, 7 * method + quality):
            data = _webp(img, lossless=True, method=method, quality=quality)
            assert data[12:16] == b"VP8L"
            np.testing.assert_array_equal(decode_image(data), _pil(data), err_msg=f"{size}")


@pytest.mark.parametrize("case", ["colors2", "colors3", "colors11", "colors200", "rgba",
                                  "exact", "grey"])
def test_webp_lossless_variants_match_pil(case):
    """Colour-indexed images of 2, <= 4, <= 16 and <= 256 colours (pixel
    bundling of 8, 4, 2 and 1 per pixel, at widths the bundles do not
    divide), RGBA, ``exact=True`` (the RGB under transparent pixels kept)
    and grey."""
    rng = np.random.default_rng(len(case))
    for size in WEBP_SIZES + ((21, 43),):
        img = _smooth(*size, seed=5)
        if case.startswith("colors"):
            n = int(case[6:])
            pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
            bands = (np.add.outer(np.arange(size[0]), np.arange(size[1])) // 3) % n
            img = pal[np.where(rng.random(size) < 0.2, rng.integers(0, n, size), bands)]
            kw = {}
        elif case in ("rgba", "exact"):
            img = np.dstack([img, _alpha(size, 4)])
            kw = {"exact": case == "exact"}
        else:
            img, kw = img[..., 0], {}
        data = _webp(img, lossless=True, **kw)
        np.testing.assert_array_equal(decode_image(data), _pil(data), err_msg=f"{size}")


def test_webp_encoder_settings_pil_cannot_set_are_held_by_fixtures():
    """The simple loop filter, 4 and 8 token partitions, one segment,
    sharpness 7 and no filter come from libwebp's advanced encoder, which
    PIL's save cannot reach: committed fixtures hold them (their headers
    are checked here), with PIL's decodes beside them."""
    for name, (field, value) in WEBP_ENCODER_FIXTURES.items():
        data = (FIXTURES / name).read_bytes()
        assert vp8_header_fields(data)[field] == value, name
        np.testing.assert_array_equal(decode_image(data), _pil(data), err_msg=name)


def test_webp_alpha_is_not_decoded():
    """The port checks an ``ALPH`` chunk's header but does not decode it:
    the RGB does not depend on it.  So a file whose compressed alpha alone
    is corrupt is read by the port, with the RGB of the intact file, where
    PIL (libwebp) refuses it (ROADMAP.md, queue 3's deliberate differences)."""
    rgb = _smooth(40, 40)
    alpha = (np.mgrid[:40, :40][1] * 6).astype(np.uint8)
    good = _webp(np.dstack([rgb, alpha]), quality=80)
    at = good.index(b"ALPH")
    n = struct.unpack("<I", good[at + 4:at + 8])[0]
    assert good[at + 8] & 3 == 1  # lossless-compressed alpha
    bad = good[:at + 9] + b"\xff" * (n - 1) + good[at + 8 + n:]
    with pytest.raises(OSError):
        _pil(bad)
    np.testing.assert_array_equal(decode_image(bad), _pil(good))
    broken_header = bytearray(good)
    broken_header[at + 8] |= 0xC0  # reserved bits set
    with pytest.raises(ValueError, match="corrupt"):
        check_image(bytes(broken_header))


@pytest.mark.parametrize("kind", ["lossy", "lossless", "palette"])
def test_webp_flipped_bytes_match_pil_or_raise(kind):
    """Random bytes past the frame header overwritten (seeded): wherever
    PIL still decodes the file, the port gives the same bytes, and where
    the port raises, so does PIL (the decoders read the chunk's pad byte as
    libwebp's demuxer hands it over)."""
    img = _smooth(24, 40, seed=4)
    if kind == "palette":
        img = (img // 64 * 64).astype(np.uint8)
    data = _webp(img, quality=70) if kind == "lossy" else _webp(img, lossless=True)
    rng = np.random.default_rng(len(kind))
    both = 0
    for _ in range(150):
        bad = bytearray(data)
        for at in rng.integers(30, len(bad), rng.integers(1, 4)):
            bad[at] = rng.integers(0, 256)
        try:
            want = _pil(bytes(bad))
        except (ValueError, OSError, SyntaxError):
            want = None
        try:
            got = decode_image(bytes(bad))
        except ValueError as e:
            assert want is None and "ROADMAP" not in str(e), str(e)
            continue
        if want is not None:
            np.testing.assert_array_equal(got, want)
            both += 1
    assert both >= 10


def test_webp_truncated_and_corrupt_files_raise():
    """Cut files (also with their RIFF and chunk sizes cut to match, so the
    bitstreams themselves end early) and broken headers raise ``ValueError``
    ("truncated" / "corrupt"), not ROADMAP."""
    img = _smooth(40, 50, seed=2)
    for data in (_webp(img, quality=80), _webp(img, lossless=True)):
        assert decode_image(data).shape == (40, 50, 3)
        cuts = [data[:n] for n in (12, 20, 30, len(data) // 2, len(data) - 1)]
        for n in (40, len(data) // 3, len(data) - 8):
            cut = bytearray(data[:n])
            cut[4:8] = struct.pack("<I", n - 8)
            cut[16:20] = struct.pack("<I", n - 20)
            cuts.append(bytes(cut))
        for bad in cuts:
            for fn in (decode_image, check_image) if len(bad) < 30 else (decode_image,):
                with pytest.raises(ValueError, match="truncated|corrupt") as e:
                    fn(bad)
                assert "ROADMAP" not in str(e.value)
    lossy = bytearray(_webp(img, quality=80))
    lossy[23:26] = b"\0\0\0"  # the VP8 start code
    lossless = bytearray(_webp(img, lossless=True))
    lossless[20] = 0x2e  # the VP8L signature
    extended = bytearray(_webp(np.dstack([img, _alpha((40, 50), 1)]), quality=80))
    extended[24:27] = struct.pack("<I", 60)[:3]  # the canvas width
    for bad in (lossy, lossless, extended):
        with pytest.raises(ValueError, match="corrupt"):
            decode_image(bytes(bad))


@pytest.mark.parametrize("case", ["lossy_full", "lossless_offset", "alpha_blend", "corner",
                                  "anmf_size_differs", "later_frame_corrupt", "pil_lossy",
                                  "pil_lossless", "pil_rgba"])
def test_animated_webp_first_frame_matches_pil(case):
    """Animated files, built by hand or by PIL's ``save_all``: the port
    gives PIL's first frame on its canvas (zero outside the frame, never
    blended, whatever the frame asks), ``check_image`` reads the canvas
    size, and a corrupt bitstream in a later frame (whose header alone the
    demuxer checks) does not stop either."""
    a, b = _smooth(40, 50, seed=1), _smooth(24, 30, seed=2)
    lossy, lossless = _webp(a, quality=80), _webp(b, lossless=True)
    with_alpha = _webp(np.dstack([b, _alpha((24, 30), 3)]), quality=80)
    if case.startswith("pil"):
        frames = [Image.fromarray(_smooth(33, 41, seed=i)) for i in range(3)]
        if case == "pil_rgba":
            frames = [f.convert("RGBA") for f in frames]
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=40,
                       lossless=case == "pil_lossless")
        data = buf.getvalue()
    elif case == "later_frame_corrupt":
        bad = bytearray(lossy)
        bad[40:70] = b"\xff" * 30
        data = animated_webp_bytes((64, 48), [(lossless, 10, 6, 0), (bytes(bad), 0, 0, 0)])
    elif case == "anmf_size_differs":  # the demuxer takes the bitstream's size over the ANMF's
        data = bytearray(animated_webp_bytes((64, 48), [(lossless, 10, 6, 0)]))
        at = data.index(b"ANMF") + 14
        data[at:at + 6] = struct.pack("<I", 62)[:3] * 2
        data = bytes(data)
    else:
        frames = {"lossy_full": [(lossy, 0, 0, 0), (lossless, 10, 6, 0)],
                  "lossless_offset": [(lossless, 10, 6, 0), (lossy, 0, 0, 1)],
                  "alpha_blend": [(with_alpha, 4, 8, 0), (lossless, 0, 0, 2)],
                  "corner": [(lossless, 34, 24, 3)]}[case]
        data = animated_webp_bytes((50, 40) if case == "lossy_full" else (64, 48), frames,
                                   alpha=case == "alpha_blend")
    want = _pil(data)
    assert check_image(data) is None
    np.testing.assert_array_equal(decode_image(data), want)


def test_animated_webp_corrupt_files_raise():
    """What libwebp's demuxer refuses, PIL refuses and the port raises
    ("corrupt"): a frame outside the canvas (the first or a later one),
    ALPH before a VP8L frame, a frame without an image, ANMF before ANIM,
    ANMF without the animation flag, no frame at all, a cut file."""
    still = _webp(_smooth(24, 30, seed=2), quality=80)
    lossless = _webp(_smooth(24, 30), lossless=True)
    good = animated_webp_bytes((64, 48), [(lossless, 10, 6, 0), (still, 0, 0, 0)])
    no_flag = bytearray(good)
    no_flag[20] = 0
    alph = _riff_chunk(b"ALPH", bytes([0]) + bytes(24 * 30))
    bodies = {"outside": animated_webp_bytes((64, 48), [(lossless, 40, 6, 0)]),
              "later outside": animated_webp_bytes((64, 48), [(lossless, 0, 0, 0),
                                                              (still, 40, 30, 0)]),
              "no flag": bytes(no_flag), "cut": good[:len(good) - 30]}
    vp8x_anim = good[:good.index(b"ANMF")]
    anmf = good[good.index(b"ANMF"):]
    first = anmf[:8 + struct.unpack("<I", anmf[4:8])[0]]
    bare = lossless[12:]
    header16 = first[8:24]

    def riff(body):
        return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body

    bodies["ALPH and VP8L"] = riff(vp8x_anim[12:] + _riff_chunk(b"ANMF", header16 + alph + bare))
    bodies["no image"] = riff(vp8x_anim[12:] + _riff_chunk(b"ANMF", header16 + alph))
    bodies["ANMF before ANIM"] = riff(vp8x_anim[12:30] + first)
    bodies["no frame"] = riff(vp8x_anim[12:])
    for what, data in bodies.items():
        with pytest.raises(OSError):
            _pil(data)
        with pytest.raises(ValueError, match="corrupt or truncated WebP") as e:
            decode_image(data)
        assert "ROADMAP" not in str(e.value), what


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


def _palette_image(rng, h: int, w: int, n: int) -> np.ndarray:
    """Indices with runs (stripes) broken by noise: encoded and absolute
    runs both."""
    stripes = (np.arange(w)[None, :] // 5 + np.arange(h)[:, None] // 3) % n
    return np.where(rng.random((h, w)) < 0.3, rng.integers(0, n, (h, w)), stripes)


@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("rle4", [False, True])
def test_bmp_rle_matches_pil(rle4, top_down):
    """RLE8 and RLE4 files from :func:`rle_commands` (end of line after
    each row, end of bitmap), also with odd RLE4 absolute runs, which PIL
    reads short; a palette shorter than the indices reach; grey palettes."""
    rng = np.random.default_rng(2 * rle4 + top_down)
    n = 16 if rle4 else 256
    for h, w in ((1, 1), (3, 5), (9, 17), (20, 13), (7, 300)):
        idx = _palette_image(rng, h, w, n)
        for pal in (rng.integers(0, 256, (n - 3, 3)), np.repeat(np.arange(n)[:, None], 3, 1)):
            data = bmp_rle_bytes(idx, rle4, pal, top_down=top_down)
            np.testing.assert_array_equal(decode_image(data), _pil(data), err_msg=f"{h}x{w}")
        rows = idx if top_down else idx[::-1]
        data = bmp_rle_bytes(idx, rle4, pal, rle_commands(rows, rle4, odd_runs=True), top_down)
        np.testing.assert_array_equal(decode_image(data), _pil(data), err_msg=f"odd {h}x{w}")


@pytest.mark.parametrize("rle4", [False, True])
def test_bmp_rle_escapes_match_pil(rle4):
    """Hand-written command streams: runs cut at the row's end, end of
    line on a full row, delta escapes (PIL skips two bytes before reading
    the pair), absolute runs at odd file positions, end of bitmap before
    the last row (PIL raises, so does the port), and random streams
    (whatever PIL gives, the port gives; where PIL fails, the port
    raises)."""
    pal = np.random.default_rng(9).integers(0, 256, (16, 3))
    v = 0x3A if rle4 else 7
    streams = [
        bytes([200, v, 0, 0, 3, v, 0, 0, 0, 1]),                          # run cut at width
        bytes([5, v, 0, 0, 0, 0, 2, v, 0, 0, 0, 1]),                      # EOL on a full row
        bytes([0, 2, 9, 9, 2, 1, 1, v, 0, 0, 5, v, 0, 0, 0, 1]),          # delta
        bytes([1, v, 0, 3, 1, 2, 3, 0, 0, 5, v, 0, 0, 0, 1]),             # absolute at odd pos
        bytes([0, 4, 0x12, 0x34, 0x56, 0x78, 1, v, 0, 0, 5, v, 0, 1]),    # absolute, even
        bytes([5, v, 0, 0, 0, 1]),                                        # ends early
        bytes([0, 5, 0x12, 0x34, 0x56, 0, 0, 0, 5, v, 0, 0, 5, v, 0, 1]),  # odd RLE4 run
    ]
    rng = np.random.default_rng(int(rle4))
    for _ in range(150):
        cmds = bytearray()
        for _ in range(rng.integers(1, 12)):
            k = rng.integers(0, 5)
            if k == 0:
                cmds += bytes([rng.integers(1, 9), rng.integers(0, 256)])
            elif k == 1:
                cmds += b"\0\0"
            elif k == 2:
                cmds += bytes([0, 2, *rng.integers(0, 4, 4)])
            else:
                n = int(rng.integers(3, 12))
                cmds += bytes([0, n, *rng.integers(0, 256, n)])
        streams.append(bytes(cmds + b"\0\1"))
    passed = 0
    for cmds in streams:
        data = bmp_rle_bytes(np.zeros((3, 5), np.int64), rle4, pal, cmds)
        try:
            want = _pil(data)
        except (ValueError, OSError):
            with pytest.raises(ValueError, match="truncated"):
                decode_image(data)
            continue
        np.testing.assert_array_equal(decode_image(data), want, err_msg=cmds.hex())
        passed += 1
    assert passed >= 60


BITFIELD_MASKS = {"565": (0xF800, 0x7E0, 0x1F), "555": (0x7C00, 0x3E0, 0x1F),
                  "bgr24": (0xFF0000, 0xFF00, 0xFF), "bgrx": (0xFF0000, 0xFF00, 0xFF, 0),
                  "xbgr": (0xFF000000, 0xFF0000, 0xFF00, 0),
                  "bgxr": (0xFF000000, 0xFF00, 0xFF, 0),
                  "abgr": (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                  "rgba": (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                  "bgra": (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                  "bgar": (0xFF000000, 0xFF00, 0xFF, 0xFF0000), "zero": (0, 0, 0, 0)}
# an alpha mask is read from a header of 56 bytes or more
BITFIELD_CASES = [(layout, header) for layout, m in BITFIELD_MASKS.items()
                  for header in (40, 56, 108, 124) if header > 40 or len(m) == 3 or not m[3]]


@pytest.mark.parametrize("layout,header", BITFIELD_CASES)
def test_bmp_bitfields_match_pil(layout, header):
    """``BI_BITFIELDS`` with every mask set PIL knows, the masks after a
    40-byte header or inside a larger one."""
    masks = BITFIELD_MASKS[layout]
    bits = 16 if len(masks) == 3 and masks[0] < 0x10000 else 24 if len(masks) == 3 else 32
    rng = np.random.default_rng(bits)
    for h, w in ((1, 1), (3, 5), (9, 17)):
        data = bmp_bitfield_bytes(rng.integers(0, 256, (h, w, 3)), bits, masks, header)
        np.testing.assert_array_equal(decode_image(data), _pil(data), err_msg=f"{h}x{w}")


# --------------------------------------------------------------- fixtures
def _fixture_names():
    return sorted(p.name for p in FIXTURES.iterdir() if p.suffix != ".npy"
                  and p.suffix != ".py")


def test_committed_fixtures_decode_to_their_pil_decodes():
    """Each committed image equals PIL's decode of it now and the ``.npy``
    committed beside it (the card's machine checks against the latter)."""
    names = _fixture_names()
    assert sum(n.endswith(".jpg") for n in names) >= 6 and len(names) >= 10
    assert set(WEBP_FIXTURES + BMP_FIXTURES) <= set(names)
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
    (d / "06.webp").write_bytes(_webp(_smooth(29, 35, seed=7), quality=75))
    (d / "07.webp").write_bytes(_webp(_smooth(33, 27, seed=8), lossless=True))
    (d / "08.jpg").write_bytes(_jpeg(_smooth(35, 29, seed=9), quality=85, progressive=True))
    Image.fromarray(_smooth(30, 34, seed=10)).convert("CMYK").save(d / "09.jpg", quality=85)
    (d / "10.webp").write_bytes(animated_webp_bytes(
        (34, 30), [(_webp(_smooth(20, 16, seed=11), lossless=True), 6, 4, 0),
                   (_webp(_smooth(30, 34, seed=12), quality=70), 0, 0, 0)]))


def test_prepare_on_jpeg_bmp_and_png_writes_the_jax_store(tmp_path):
    """The port's ``prepare_data`` on a folder of JPEG (baseline,
    progressive, CMYK), BMP, palette / interlaced PNG and lossy / lossless /
    animated WebP files: every record decodes to the JAX ``prepare_data``'s
    (which opens the files with PIL)."""
    d = tmp_path / "imgs"
    _mixed_folder(d)
    assert j_prepare(str(d), str(tmp_path / "jax"), sizes=(16, 24), n_workers=1) == 11
    assert prepare_data(str(d), str(tmp_path / "port"), sizes=(16, 24), n_workers=2) == 11
    with JReader(str(tmp_path / "jax")) as ref, RecordReader(str(tmp_path / "port")) as ours:
        keys = list(ref.keys())
        assert list(ours.keys()) == keys and len(keys) == 23
        for k in keys[:-1]:
            np.testing.assert_array_equal(png.decode_png(ours.get(k)), _pil(ref.get(k)),
                                          err_msg=k)


def test_prepare_refuses_webp_before_writing(tmp_path):
    """A file PIL refuses too among readable ones stops ``prepare_data``
    before it writes anything: an animated WebP whose second frame lies
    outside its canvas, and a 12-bit JPEG."""
    still = _webp(_smooth(16, 16), quality=80)
    outside = animated_webp_bytes((24, 24), [(still, 0, 0, 0), (still, 12, 0, 0)])
    with pytest.raises(OSError):
        _pil(outside)
    twelve_bit = _sof_patched(_jpeg(_smooth(16, 16), quality=90), precision=12)
    for name, data, message in (("08.webp", outside, "corrupt or truncated WebP: ANMF frame "
                                                     "outside the canvas"),
                                ("08.jpg", twelve_bit, "12-bit JPEG is not read by the port, "
                                                       "nor by PIL")):
        d = tmp_path / name.replace(".", "_")
        _mixed_folder(d)
        (d / name).write_bytes(data)
        with pytest.raises(ValueError, match=f"{name}: {message}"):
            prepare_data(str(d), str(tmp_path / "out"), sizes=(16,), n_workers=1)
        assert not (tmp_path / "out").exists()


def test_calc_fid_stats_reads_a_jpeg_folder_as_pil_decodes_it(tmp_path, monkeypatch):
    """``calc_fid_stats`` on JPEG (baseline, progressive, CMYK), BMP, PNG and
    WebP (still, animated) files gives the statistics of the same images
    stored as PIL's decodes (random Inception weights)."""
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
    assert calc_cli.main(["imgs", "--out", "a.npz", *args]) == 11
    assert calc_cli.main(["decoded", "--out", "b.npz", *args]) == 11
    with np.load("a.npz") as a, np.load("b.npz") as b:
        np.testing.assert_array_equal(a["mu"], b["mu"])
        np.testing.assert_array_equal(a["sigma"], b["sigma"])


def test_bmp_16_bit_and_grey_palettes_match_pil():
    """16-bit ``BI_RGB`` (5-5-5, the top bit ignored) over every value, and
    palettes PIL reads as grey: entry i grey i (``L``: an index past the
    entries is still grey), two entries black and white (``1``: read bit by
    bit whatever the depth)."""
    values = np.arange(65536).reshape(256, 256)
    rows = b"".join(r.astype("<u2").tobytes() for r in values[::-1])
    data = _bmp_file(256, 256, 16, 0, rows)
    np.testing.assert_array_equal(decode_image(data), _pil(data))
    rng = np.random.default_rng(0)
    for bits, pal in ((8, np.repeat(np.arange(16)[:, None], 3, 1)),
                      (8, np.array([[0, 0, 0], [255, 255, 255]])),
                      (4, np.array([[0, 0, 0], [255, 255, 255]])),
                      (1, np.array([[0, 0, 0], [255, 255, 255]])),
                      (4, np.repeat(np.arange(16)[:, None], 3, 1))):
        for h, w in ((3, 1), (5, 3), (9, 17)):
            data = bmp_bytes(rng.integers(0, 1 << bits, (h, w)), bits, pal)
            try:
                want = _pil(data)
            except (ValueError, OSError):
                with pytest.raises(ValueError, match="nor by PIL"):
                    decode_image(data)
                continue
            np.testing.assert_array_equal(decode_image(data), want, err_msg=f"{bits} {h}x{w}")


def test_bmp_kinds_pil_refuses_raise_saying_so():
    """JPEG- and PNG-compressed and alpha bit-field bitmaps, masks PIL does
    not know, RLE over a black-and-white palette and 2-bit pixels: PIL
    refuses each, and the port raises saying so (no ROADMAP gap)."""
    rgb = np.zeros((4, 4, 3), np.int64)
    bw = np.array([[0, 0, 0], [255, 255, 255]])
    jpeg = bytearray(bmp_bytes(rgb, 24))
    jpeg[30:34] = struct.pack("<I", 4)
    png_kind = bytearray(bmp_bytes(rgb, 24))
    png_kind[30:34] = struct.pack("<I", 5)
    two_bit = bytearray(bmp_bytes(np.zeros((4, 4), np.int64), 4, bw[[0, 1, 1, 0]]))
    two_bit[28:30] = struct.pack("<H", 2)
    cases = {"JPEG": bytes(jpeg), "PNG": bytes(png_kind),
             "alpha bit-field": bmp_bitfield_bytes(rgb, 32, (0xFF0000, 0xFF00, 0xFF, 0), 56, 6),
             "bit-field masks": bmp_bitfield_bytes(rgb, 16, (0xF000, 0xF00, 0xF0)),
             "black-and-white": bmp_rle_bytes(np.zeros((4, 4), np.int64), False, bw),
             "2-bit": bytes(two_bit)}
    for what, data in cases.items():
        with pytest.raises((ValueError, OSError)):
            _pil(data)
        for fn in (decode_image, check_image):
            with pytest.raises(ValueError, match="nor by PIL") as e:
                fn(data)
            assert what in str(e.value) and "ROADMAP" not in str(e.value), str(e.value)
