"""PNG decode and encode with ``zlib`` and the port's native unfilter loop.

The counterpart of what the JAX package does with PIL:
``Image.open(io.BytesIO(data)).convert("RGB")`` in
``sdface_gan_tpu/data/dataset.py`` and ``Image.save(format="PNG")`` in
``sdface_gan_tpu/data/prepare.py``.  The decoder takes 8-bit grey, grey +
alpha, RGB and RGBA, non-interlaced (what the record stores hold: PIL- or
port-written 8-bit RGB), and returns [H, W, 3] uint8 as PIL's
``convert("RGB")`` does (grey replicated, alpha dropped).  Palette, 16-bit,
sub-byte and interlaced files raise.  The encoder writes 8-bit RGB with
filter type 0; its files are not PIL's byte for byte, but they decode to
the same pixels.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, NamedTuple, Tuple

import numpy as np

from ..native import png_unfilter

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (3, palette, is refused)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


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


def parse(data: bytes) -> Tuple[Header, List[bytes]]:
    """The header and the payloads of the IDAT chunks, in order."""
    chunks = _chunks(data)
    if not chunks or chunks[0][0] != b"IHDR":
        raise ValueError("PNG file does not start with IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = struct.unpack(">IIBBBBB", chunks[0][1])
    return Header(w, h, depth, ctype, interlace), [p for t, p in chunks if t == b"IDAT"]


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8 RGB."""
    hdr, idat = parse(data)
    if hdr.color_type == 3:
        raise ValueError("palette PNG files are not supported (the stores hold 8-bit RGB)")
    if hdr.color_type not in _CHANNELS:
        raise ValueError(f"PNG colour type {hdr.color_type} is not valid")
    if hdr.bit_depth != 8:
        raise ValueError(f"{hdr.bit_depth}-bit PNG files are not supported, only 8-bit")
    if hdr.interlace != 0:
        raise ValueError("interlaced PNG files are not supported")
    if not idat:
        raise ValueError("PNG file has no IDAT chunk")
    c = _CHANNELS[hdr.color_type]
    pixels = png_unfilter(zlib.decompress(b"".join(idat)), hdr.height, hdr.width * c, c)
    pixels = pixels.reshape(hdr.height, hdr.width, c)
    if c == 3:
        return pixels
    if c == 4:
        return np.ascontiguousarray(pixels[..., :3])
    return np.repeat(pixels[..., :1], 3, axis=-1)  # grey (+ alpha)


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
