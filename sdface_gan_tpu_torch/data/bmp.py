"""BMP decoding without PIL: what PIL 12's ``Image.open(path).convert("RGB")``
gives.

- ``BI_RGB``: 1-, 4- and 8-bit palette images (palette entries BGR, of 3
  bytes after a 12-byte header, of 4 after a larger one), 16-bit 5-5-5 and
  24- and 32-bit BGR(X) ones, stored bottom-up (positive height) or
  top-down (negative height).
- ``BI_RLE8`` and ``BI_RLE4``: run-length palette images, read as PIL reads
  them (``native/bmp_rle.cpp`` says how), positions no command writes
  zero.
- ``BI_BITFIELDS`` with the masks PIL knows: 16-bit 5-6-5 and 5-5-5, 24-bit
  BGR and 32-bit layouts with or without an alpha mask (which RGB drops).
- A palette whose entries are all grey makes PIL read the pixels as grey
  (``L``, or ``1`` for two entries, black then white), and so the port.

The kinds PIL refuses too (JPEG- or PNG-compressed and alpha bit-field
bitmaps, other masks and bit depths) raise ``ValueError`` saying so.
"""

from __future__ import annotations

import struct

import numpy as np

from ..native import lib

SIGNATURE = b"BM"
_INFO_HEADERS = (40, 52, 56, 108, 124)  # BITMAPINFOHEADER and its extensions
_RLE = {1: "RLE8", 2: "RLE4"}
_REFUSED = {4: "JPEG", 5: "PNG", 6: "alpha bit-field"}
# PIL's bit-field layouts: (r, g, b, a) masks -> the bytes of R, G, B (32
# bits; an all-zero set is read as BGRA), (r, g, b) masks -> bits of green
# (16 bits)
_MASKS_32 = {(0xFF0000, 0xFF00, 0xFF, 0): (2, 1, 0), (0xFF000000, 0xFF0000, 0xFF00, 0): (3, 2, 1),
             (0xFF000000, 0xFF00, 0xFF, 0): (3, 1, 0),
             (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1),
             (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2),
             (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0),
             (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0), (0, 0, 0, 0): (2, 1, 0)}
_MASKS_16 = {(0xF800, 0x7E0, 0x1F): 6, (0x7C00, 0x3E0, 0x1F): 5}


def _pil_refuses(what: str) -> ValueError:
    return ValueError(f"{what} is not read by the port, nor by PIL, which the JAX package "
                      "reads images with")


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
        if self.bits not in (1, 4, 8, 16, 24, 32):
            raise _pil_refuses(f"{self.bits}-bit BMP")
        self.compression = compression
        self.masks = None
        if compression == 3:
            n = 4 if size >= 56 else 3  # an alpha mask from the 56-byte header on
            if len(data) < 54 + 4 * n:
                raise ValueError("BMP bit-field masks truncated")
            self.masks = struct.unpack(f"<{n}I", data[54:54 + 4 * n]) + (0,) * (4 - n)
            if not (self.bits == 32 and self.masks in _MASKS_32
                    or self.bits == 24 and self.masks[:3] == (0xFF0000, 0xFF00, 0xFF)
                    or self.bits == 16 and self.masks[:3] in _MASKS_16):
                raise _pil_refuses(f"{self.bits}-bit BMP with bit-field masks "
                                   f"{tuple(hex(m) for m in self.masks)}")
        elif compression in _RLE:
            if self.bits > 8:
                raise _pil_refuses(f"{self.bits}-bit {_RLE[compression]} BMP")
        elif compression:
            raise _pil_refuses(f"{_REFUSED.get(compression, f'compression {compression}')} "
                               "BMP")
        if w <= 0 or h == 0:
            raise ValueError(f"BMP of size {w} x {h} is not valid")
        self.width, self.height, self.top_down = w, abs(h), h < 0
        self.palette_at = 14 + size
        self.colors = colors or (1 << self.bits if self.bits <= 8 else 0)
        if self.offset == self.palette_at and self.bits <= 8:
            self.offset += 4 * self.colors  # PIL: an offset at the palette skips it
        self.mode = "RGB" if self.bits > 8 else self._palette_mode(data)
        if compression in _RLE and self.mode == "1":
            raise _pil_refuses("RLE BMP with a black-and-white palette")

    def _palette_mode(self, data: bytes) -> str:
        """PIL's mode for a palette image: "L" when entry i is grey i for
        every entry, "1" when two entries are black and white, else "P"."""
        end = self.palette_at + self.colors * self.entry
        if self.colors > 256 or end > self.offset or end > len(data):
            raise ValueError(f"BMP palette of {self.colors} entries is not valid")
        entries = np.frombuffer(data, np.uint8, self.colors * self.entry, self.palette_at)
        self.palette = entries.reshape(-1, self.entry)[:, 2::-1]
        grey = np.array((0, 255) if self.colors == 2 else range(self.colors))
        if (self.palette == grey[:, None]).all():
            return "1" if self.colors == 2 else "L"
        return "P"


def _rows(hdr: Header, pixels: np.ndarray) -> np.ndarray:
    """Rows in the order read -> rows top to bottom."""
    return pixels if hdr.top_down else pixels[::-1]


def _lookup(hdr: Header, index: np.ndarray) -> np.ndarray:
    """Palette indices (or grey levels) [h, w] -> RGB [h, w, 3]."""
    if hdr.mode == "P":
        palette = np.zeros((256, 3), np.uint8)  # an index past the entries is black, as in PIL
        palette[:hdr.colors] = hdr.palette
        return palette[index]
    grey = index if hdr.mode == "L" else np.where(index != 0, 255, 0).astype(np.uint8)
    return np.repeat(grey[..., None], 3, axis=-1)


def _decode_rle(data: bytes, hdr: Header) -> np.ndarray:
    w, h = hdr.width, hdr.height
    index = np.zeros(w * h, np.uint8)
    n = lib().bmp_rle_decode(data, len(data), hdr.offset, w, h, hdr.compression == 2,
                             index.ctypes.data)
    if n < w * h:
        raise ValueError(f"BMP run-length data truncated: {max(n, 0)} of {w * h} pixels")
    return _lookup(hdr, _rows(hdr, index.reshape(h, w)))


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> [H, W, 3] uint8 RGB."""
    hdr = Header(data)
    if hdr.compression in _RLE:
        return _decode_rle(data, hdr)
    w, h, bits = hdr.width, hdr.height, hdr.bits
    stride = (bits * w + 31) // 32 * 4
    if hdr.offset + stride * h > len(data):
        raise ValueError(f"BMP pixel data truncated: {len(data) - hdr.offset} bytes for "
                         f"{h} rows of {stride}")
    rows = _rows(hdr, np.frombuffer(data, np.uint8, stride * h, hdr.offset).reshape(h, stride))
    if bits == 16:
        px = rows[:, :2 * w].reshape(h, w, 2).astype(np.uint16)
        px = px[..., 0] | (px[..., 1] << 8)
        gbits = _MASKS_16[hdr.masks[:3]] if hdr.masks else 5
        r, g, b = (px >> (5 + gbits)) & 31, (px >> 5) & ((1 << gbits) - 1), px & 31
        return np.stack([r * 255 // 31, g * 255 // ((1 << gbits) - 1), b * 255 // 31],
                        -1).astype(np.uint8)
    if bits >= 24:
        px = rows[:, :w * bits // 8].reshape(h, w, bits // 8)
        order = _MASKS_32[hdr.masks] if hdr.masks and bits == 32 else (2, 1, 0)
        return np.ascontiguousarray(px[..., list(order)])
    if hdr.mode == "L" and bits < 8:  # PIL reads one byte per pixel then
        if w > stride:
            raise _pil_refuses(f"{bits}-bit BMP with a grey palette wider than its rows")
        return _lookup(hdr, rows[:, :w])
    per = 1 if hdr.mode == "1" else bits  # PIL reads "1" bit by bit whatever the depth
    shifts = np.arange(8 - per, -1, -per, dtype=np.uint8)
    index = ((rows[:, :, None] >> shifts) & ((1 << per) - 1)).reshape(h, -1)
    return _lookup(hdr, index[:, :w])
