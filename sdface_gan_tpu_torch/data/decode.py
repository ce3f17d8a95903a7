"""The port's image decoder: the format is chosen by the file's magic
bytes, not by its name, as PIL's ``Image.open`` chooses it.

PNG (``png.py``), baseline JPEG (``jpeg.py``) and uncompressed BMP
(``bmp.py``) decode to [H, W, 3] uint8 RGB, byte for byte what the JAX
package's ``Image.open(...).convert("RGB")`` gives with PIL 12 and its
libjpeg-turbo.  WebP, the other JPEG kinds (progressive, arithmetic-coded,
lossless, 12-bit, CMYK, YCCK) and compressed BMP raise ``ValueError``
naming ROADMAP.md; so does a file of no image format the port knows.
"""

from __future__ import annotations

import numpy as np

from . import bmp, jpeg, png


def image_kind(data: bytes) -> str:
    """``"png"``, ``"jpeg"`` or ``"bmp"`` by the magic bytes."""
    if data.startswith(png.SIGNATURE):
        return "png"
    if data.startswith(jpeg.SIGNATURE):
        return "jpeg"
    if data.startswith(bmp.SIGNATURE):
        return "bmp"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        raise ValueError("WebP is not read by the port (it reads PNG, baseline JPEG and "
                         "uncompressed BMP; WebP is a gap listed in ROADMAP.md, queue 1 item 4)")
    raise ValueError("not an image the port reads (PNG, baseline JPEG or uncompressed BMP, "
                     "known by their first bytes)")


def check_image(data: bytes) -> None:
    """Raise ``ValueError`` unless the header of ``data`` is of a kind that
    :func:`decode_image` reads (the pixel data is not decoded)."""
    kind = image_kind(data)
    if kind == "png":
        png.read_header(data)
    elif kind == "jpeg":
        jpeg.jpeg_size(data)
    else:
        bmp.Header(data)


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes -> [H, W, 3] uint8 RGB."""
    kind = image_kind(data)
    if kind == "png":
        return png.decode_png(data)
    if kind == "jpeg":
        return jpeg.decode_jpeg(data)
    return bmp.decode_bmp(data)
