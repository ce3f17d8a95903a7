"""WebP decoding without PIL, through the port's native decoder
(``native/webp_decode.cpp``).

What the JAX package gets from ``Image.open(path).convert("RGB")`` with
PIL's libwebp, byte for byte: lossy VP8 key frames (libwebp's loop
filters, its "fancy" chroma upsampler and fixed-point YUV -> RGB) and
lossless VP8L images, in the simple ``VP8 `` / ``VP8L`` files, the
extended ``VP8X`` ones holding one still image, and animated files, of
which PIL gives the first frame on the canvas (zero outside the frame).
An ``ALPH`` chunk's header is checked but its alpha is not decoded: the
RGB does not depend on it.  Truncated or corrupt files raise
``ValueError``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import lib

SIGNATURE = (b"RIFF", b"WEBP")  # bytes 0-3 and 8-11; the RIFF size lies between
_CORRUPT = -1


def _run(data: bytes, out) -> tuple:
    """One call of the native decoder: (its code, height, width); an error
    code raises."""
    h, w = ctypes.c_int32(), ctypes.c_int32()
    err = ctypes.create_string_buffer(256)
    rc = lib().webp_decode(data, len(data), None if out is None else out.ctypes.data,
                           0 if out is None else out.nbytes, ctypes.byref(h), ctypes.byref(w),
                           err, len(err))
    if rc == _CORRUPT:
        raise ValueError(f"corrupt or truncated WebP: {err.value.decode()}")
    return rc, h.value, w.value


def is_webp(data: bytes) -> bool:
    """A RIFF file of form type ``WEBP``."""
    return data[:4] == SIGNATURE[0] and data[8:12] == SIGNATURE[1]


def webp_size(data: bytes) -> tuple:
    """(height, width) of WebP bytes (an animation's canvas) from the
    container and the frame headers; a truncated or corrupt file raises
    ``ValueError``."""
    _, h, w = _run(data, None)
    return h, w


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes -> [H, W, 3] uint8 RGB."""
    out = np.empty((*webp_size(data), 3), dtype=np.uint8)
    rc, _, _ = _run(data, out)
    if rc != 0:
        raise ValueError(f"WebP decoder returned {rc}")
    return out
