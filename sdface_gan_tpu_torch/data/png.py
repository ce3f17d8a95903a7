"""PNG decode and encode with ``zlib`` and the port's native unfilter loop.

The counterpart of what the JAX package does with PIL:
``Image.open(io.BytesIO(data)).convert("RGB")`` in
``sdface_gan_tpu/data/dataset.py`` and ``Image.save(format="PNG")`` in
``sdface_gan_tpu/data/prepare.py``.  The decoder takes every colour type
at every bit depth PNG allows, interlaced (Adam7) or not, and returns
[H, W, 3] uint8 as PIL 12's ``convert("RGB")`` does: grey replicated
(1, 2 and 4 bits scaled to 0..255, 16 bits clipped to 255), a palette
looked up (transparency ignored), alpha dropped, and 16-bit RGB, RGBA and
grey + alpha samples taken by their high byte.  The encoder writes 8-bit
RGB with filter type 0; its files are not PIL's byte for byte, but they
decode to the same pixels.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, NamedTuple, Tuple

import numpy as np

from ..native import png_unfilter

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (channels, the bit depths PNG allows)
_KINDS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)),
          6: (4, (8, 16))}
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


class Header(NamedTuple):
    width: int
    height: int
    bit_depth: int
    color_type: int
    interlace: int


def _chunks(data: bytes) -> List[Tuple[bytes, bytes]]:
    """Every (type, payload) up to IEND, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos, out = 8, []
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG file truncated before IEND")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(payload) != n or len(crc) != 4:
            raise ValueError(f"PNG chunk {tag!r} truncated")
        if struct.unpack(">I", crc)[0] != zlib.crc32(tag + payload) & 0xFFFFFFFF:
            raise ValueError(f"PNG chunk {tag!r} has a bad CRC")
        out.append((tag, payload))
        pos += 12 + n
        if tag == b"IEND":
            return out


def read_header(data: bytes) -> Header:
    """The IHDR of PNG bytes (the file's first chunk), checked for a colour
    type and bit depth that PNG allows."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    if len(data) < 33 or data[12:16] != b"IHDR":
        raise ValueError("PNG file does not start with IHDR")
    hdr = Header(*struct.unpack(">IIBBBBB", data[16:29])[:4], data[28])
    if hdr.color_type not in _KINDS:
        raise ValueError(f"PNG colour type {hdr.color_type} is not valid")
    if hdr.bit_depth not in _KINDS[hdr.color_type][1]:
        raise ValueError(f"PNG bit depth {hdr.bit_depth} is not valid for colour type "
                         f"{hdr.color_type}")
    if hdr.interlace not in (0, 1) or hdr.width == 0 or hdr.height == 0:
        raise ValueError("PNG header is not valid")
    return hdr


def parse(data: bytes) -> Tuple[Header, List[bytes]]:
    """The header and the payloads of the IDAT chunks, in order."""
    chunks = _chunks(data)
    if not chunks or chunks[0][0] != b"IHDR":
        raise ValueError("PNG file does not start with IHDR")
    return read_header(data), [p for t, p in chunks if t == b"IDAT"]


def _samples(raw: memoryview, h: int, w: int, c: int, depth: int) -> Tuple[np.ndarray, int]:
    """Unfilter ``h`` rows of ``w`` pixels at the start of ``raw`` ->
    ([h, w, c] samples, uint8 or uint16, the bytes used)."""
    stride = (w * c * depth + 7) // 8
    used = h * (stride + 1)
    if len(raw) < used:
        raise ValueError(f"PNG image data too short: {len(raw)} bytes for {h} rows of "
                         f"{stride} + 1")
    rows = png_unfilter(bytes(raw[:used]), h, stride, max(1, c * depth // 8))
    if depth == 16:
        return rows.view(">u2").reshape(h, w, c), used
    if depth < 8:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)
    return rows[:, :w * c].reshape(h, w, c), used


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8 RGB."""
    chunks = _chunks(data)
    hdr = read_header(data)
    idat = [p for t, p in chunks if t == b"IDAT"]
    if not idat:
        raise ValueError("PNG file has no IDAT chunk")
    c, depth = _KINDS[hdr.color_type][0], hdr.bit_depth
    raw = memoryview(zlib.decompress(b"".join(idat)))
    if hdr.interlace:
        px = np.zeros((hdr.height, hdr.width, c), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(hdr.width - x0) // dx), -(-(hdr.height - y0) // dy)
            if pw > 0 and ph > 0:
                px[y0::dy, x0::dx], used = _samples(raw[pos:], ph, pw, c, depth)
                pos += used
    else:
        px, _ = _samples(raw, hdr.height, hdr.width, c, depth)

    if hdr.color_type == 3:
        plte = next((p for t, p in chunks if t == b"PLTE"), None)
        if plte is None or len(plte) % 3 or not 0 < len(plte) <= 768:
            raise ValueError("palette PNG without a valid PLTE chunk")
        palette = np.zeros((256, 3), np.uint8)  # an index past the entries is black, as in PIL
        palette[:len(plte) // 3] = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        return palette[px[..., 0]]
    if depth == 16:
        # PIL: grey ("I;16") clips to 255, the other kinds keep the high byte
        px = np.minimum(px, 255) if hdr.color_type == 0 else px >> 8
        px = px.astype(np.uint8)
    elif depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))
    if c >= 3:
        return np.ascontiguousarray(px[..., :3])
    return np.repeat(px[..., :1], 3, axis=-1)  # grey (+ alpha)


def encode_png(rgb: np.ndarray, level: int = 6) -> bytes:
    """[H, W, 3] uint8 -> 8-bit RGB PNG bytes (filter type 0 on every row)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] uint8, got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.zeros((h, 1 + 3 * w), dtype=np.uint8)
    rows[:, 1:] = rgb.reshape(h, 3 * w)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        crc = zlib.crc32(tag + payload) & 0xFFFFFFFF
        return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", crc)

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))
