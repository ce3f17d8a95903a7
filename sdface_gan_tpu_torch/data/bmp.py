"""Uncompressed BMP decoding without PIL.

What ``Image.open(path).convert("RGB")`` gives for a ``BI_RGB`` bitmap: 1-,
4- and 8-bit palette images (palette entries BGR, of 3 bytes after a
12-byte header, of 4 after a larger one) and 24- and 32-bit BGR(X) ones,
stored bottom-up (positive height) or top-down (negative height).  RLE,
bit-field and 16-bit bitmaps raise ``ValueError`` naming ROADMAP.md.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"BM"
_INFO_HEADERS = (40, 52, 56, 108, 124)  # BITMAPINFOHEADER and its extensions
_COMPRESSION = {1: "RLE8", 2: "RLE4", 3: "bit-field", 4: "JPEG", 5: "PNG", 6: "alpha bit-field"}


class Header:
    """The fields of a BMP's file and DIB headers that decoding needs."""

    def __init__(self, data: bytes):
        if data[:2] != SIGNATURE or len(data) < 26:
            raise ValueError("not a BMP file (bad signature)")
        self.offset, size = struct.unpack("<II", data[10:18])
        if size == 12:  # BITMAPCOREHEADER
            w, h, _, self.bits = struct.unpack("<HHHH", data[18:26])
            compression, colors, self.entry = 0, 0, 3
        elif size in _INFO_HEADERS and len(data) >= 14 + 40:
            w, h, _, self.bits, compression, _, _, _, colors = struct.unpack(
                "<iiHHIIiiI", data[18:50])
            self.entry = 4
        else:
            raise ValueError(f"BMP with a {size}-byte header is not read by the port")
        if compression:
            kind = _COMPRESSION.get(compression, f"compression {compression}")
            raise ValueError(f"{kind} BMP is not read by the port (it reads uncompressed "
                             "BMP; the others are a gap listed in ROADMAP.md, queue 1 item 4)")
        if self.bits not in (1, 4, 8, 24, 32):
            raise ValueError(f"{self.bits}-bit BMP is not read by the port (it reads 1, 4, 8, "
                             "24 and 32 bits; the others are a gap listed in ROADMAP.md, "
                             "queue 1 item 4)")
        if w <= 0 or h == 0:
            raise ValueError(f"BMP of size {w} x {h} is not valid")
        self.width, self.height, self.top_down = w, abs(h), h < 0
        self.palette_at = 14 + size
        self.colors = colors or (1 << self.bits if self.bits <= 8 else 0)


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> [H, W, 3] uint8 RGB."""
    hdr = Header(data)
    w, h, bits = hdr.width, hdr.height, hdr.bits
    stride = (bits * w + 31) // 32 * 4
    if hdr.offset + stride * h > len(data):
        raise ValueError(f"BMP pixel data truncated: {len(data) - hdr.offset} bytes for "
                         f"{h} rows of {stride}")
    rows = np.frombuffer(data, np.uint8, stride * h, hdr.offset).reshape(h, stride)
    if not hdr.top_down:
        rows = rows[::-1]
    if bits >= 24:
        px = rows[:, :w * bits // 8].reshape(h, w, bits // 8)
        return np.ascontiguousarray(px[..., 2::-1])  # BGR(X) -> RGB
    end = hdr.palette_at + hdr.colors * hdr.entry
    if hdr.colors > 256 or end > hdr.offset or end > len(data):
        raise ValueError(f"BMP palette of {hdr.colors} entries is not valid")
    palette = np.zeros((256, 3), np.uint8)  # an index past the entries is black, as in PIL
    entries = np.frombuffer(data, np.uint8, hdr.colors * hdr.entry, hdr.palette_at)
    palette[:hdr.colors] = entries.reshape(-1, hdr.entry)[:, 2::-1]
    if bits < 8:
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        rows = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(h, -1)
    return palette[rows[:, :w]]
