"""JPEG decoding without PIL, through the port's native decoder
(``native/jpeg_decode.cpp``).

What the JAX package gets from ``Image.open(path).convert("RGB")`` with
PIL's libjpeg-turbo, byte for byte, for every kind PIL reads: sequential
(baseline and extended) and progressive Huffman files (with libjpeg's
block smoothing where the scans leave coefficients unrefined),
arithmetic-coded sequential and progressive files, lossless Huffman files
(predictors 1-7, any point transform), at 8 bits with 1 (grey), 3 (YCbCr
or RGB) or 4 (CMYK or YCCK, then PIL's CMYK -> RGB) components, sampled 1
to 4 times per direction in any whole ratio, with or without restart
markers.  libjpeg's ISLOW integer IDCT, upsamplers and colour tables give
the bytes.

The kinds PIL refuses too (12- and 16-bit, hierarchical, lossless
arithmetic-coded, 2 or more than 4 components, fractional sampling ratios,
a height left to a DNL marker) raise ``ValueError`` saying so; truncated
or corrupt files raise naming the fault.
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
        raise ValueError(f"{err.value.decode()} is not read by the port, nor by PIL, which the "
                         "JAX package reads images with")
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
