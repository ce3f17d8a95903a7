"""Baseline JPEG decoding without PIL, through the port's native decoder
(``native/jpeg_decode.cpp``).

What the JAX package gets from ``Image.open(path).convert("RGB")`` with
PIL's libjpeg-turbo, byte for byte: the ISLOW integer IDCT, the fancy
h2v1 / h2v2 upsamplers and libjpeg's YCbCr -> RGB tables.  Baseline (and
extended) sequential Huffman files at 8 bits with 1 or 3 components,
sampled 4:4:4, 4:2:2 or 4:2:0, with or without restart markers, are read;
progressive, lossless, arithmetic-coded, 12-bit, CMYK and YCCK files and
other samplings raise ``ValueError`` naming ROADMAP.md, as do truncated or
corrupt ones.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import lib

SIGNATURE = b"\xff\xd8\xff"
_CORRUPT, _UNSUPPORTED = -1, -2


def _run(data: bytes, out) -> tuple:
    """One call of the native decoder: (its code, height, width); an error
    code raises."""
    h, w = ctypes.c_int32(), ctypes.c_int32()
    err = ctypes.create_string_buffer(256)
    rc = lib().jpeg_decode(data, len(data), None if out is None else out.ctypes.data,
                           0 if out is None else out.nbytes, ctypes.byref(h), ctypes.byref(w),
                           err, len(err))
    if rc == _UNSUPPORTED:
        raise ValueError(f"{err.value.decode()} is not read by the port (it reads baseline "
                         "JPEG; the other kinds are a gap listed in ROADMAP.md, queue 1 item 4)")
    if rc == _CORRUPT:
        raise ValueError(f"corrupt or truncated JPEG: {err.value.decode()}")
    return rc, h.value, w.value


def jpeg_size(data: bytes) -> tuple:
    """(height, width) of JPEG bytes from the markers up to the frame
    header; a kind the port does not read raises ``ValueError``."""
    _, h, w = _run(data, None)
    return h, w


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> [H, W, 3] uint8 RGB."""
    out = np.empty((*jpeg_size(data), 3), dtype=np.uint8)
    rc, _, _ = _run(data, out)
    if rc != 0:
        raise ValueError(f"JPEG decoder returned {rc}")
    return out
