"""The port's image decoder: the format is chosen by the file's magic
bytes, not by its name, as PIL's ``Image.open`` chooses it.

PNG (``png.py``), JPEG (``jpeg.py``: sequential, progressive,
arithmetic-coded and lossless; grey, YCbCr, RGB, CMYK and YCCK; every whole
sampling ratio), WebP (``webp.py``: lossy and lossless, still and the first
frame of an animation) and BMP (``bmp.py``: uncompressed, RLE8, RLE4,
bit-field and 16-bit) decode to [H, W, 3] uint8 RGB, byte for byte what the
JAX package's ``Image.open(...).convert("RGB")`` gives with PIL 12, its
libjpeg-turbo and its libwebp.  The kinds PIL refuses too (12- and 16-bit,
hierarchical or lossless arithmetic-coded JPEG, fractional samplings;
JPEG- or PNG-compressed BMP, unusual bit fields) raise ``ValueError``
saying so, as does a file of no image format the port knows.
"""

from __future__ import annotations

import numpy as np

from . import bmp, jpeg, png, webp


def image_kind(data: bytes) -> str:
    """``"png"``, ``"jpeg"``, ``"webp"`` or ``"bmp"`` by the magic bytes."""
    if data.startswith(png.SIGNATURE):
        return "png"
    if data.startswith(jpeg.SIGNATURE):
        return "jpeg"
    if webp.is_webp(data):
        return "webp"
    if data.startswith(bmp.SIGNATURE):
        return "bmp"
    raise ValueError("not an image the port reads (PNG, JPEG, WebP or BMP, known by their "
                     "first bytes)")


def check_image(data: bytes) -> None:
    """Raise ``ValueError`` unless the header of ``data`` is of a kind that
    :func:`decode_image` reads (the pixel data is not decoded)."""
    kind = image_kind(data)
    if kind == "png":
        png.read_header(data)
    elif kind == "jpeg":
        jpeg.jpeg_size(data)
    elif kind == "webp":
        webp.webp_size(data)
    else:
        bmp.Header(data)


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes -> [H, W, 3] uint8 RGB."""
    kind = image_kind(data)
    if kind == "png":
        return png.decode_png(data)
    if kind == "jpeg":
        return jpeg.decode_jpeg(data)
    if kind == "webp":
        return webp.decode_webp(data)
    return bmp.decode_bmp(data)
