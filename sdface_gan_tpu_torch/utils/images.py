"""Image grids as PNG files, written by the port's own encoder
(``data/png.py``; no imaging library needed)."""

from __future__ import annotations

import numpy as np

from ..data.png import encode_png


def to_uint8(img) -> np.ndarray:
    """[-1, 1] float -> uint8."""
    return np.clip((np.asarray(img, dtype=np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 array as an 8-bit RGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def save_image_grid(images, path: str, nrow: int = 8) -> None:
    """Save an [N, H, W, 3] batch (values in [-1, 1]) as a tiled PNG grid."""
    imgs = to_uint8(images)
    n, h, w, c = imgs.shape
    ncol = min(nrow, n)
    rows = (n + ncol - 1) // ncol
    grid = np.zeros((rows * h, ncol * w, c), dtype=np.uint8)
    for i in range(n):
        r, col = divmod(i, ncol)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = imgs[i]
    write_png(path, grid)
