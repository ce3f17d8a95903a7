"""Real images for FID: a directory of image files, or a record store, as
batches of [n, H, W, 3] float32 in [-1, 1].

The JAX package's scoring entries read directories with PIL
(``convert("RGB")``, then ``resize(LANCZOS)``); the port decodes PNG,
JPEG, WebP and BMP with its own decoders, byte for byte as PIL does
(``data/decode.py``), and resizes with its PIL-exact LANCZOS
(``data/resample.py``).  A directory is checked whole before any work
starts: a file the port cannot decode (a kind PIL refuses too, or a
corrupt one) raises there, and so does a ``.npy`` file (PIL, which the JAX
package opens every file with, reads none).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional

import numpy as np

from ..data.prepare import check_readable, load_image
from ..data.resample import resize


def is_record_store(path: str) -> Optional[str]:
    """The record-store directory at ``path`` (the store itself or a parent
    holding ``records/``, the ``prepare_data`` layout), or None."""
    for cand in (os.path.join(path, "records"), path):
        if os.path.exists(os.path.join(cand, "index.bin")):
            return cand
    return None


def list_image_files(directory: str, n_images: Optional[int] = None) -> List[str]:
    """The first ``n_images`` file names of ``directory`` in sorted order,
    every one of them readable by the port (else ``ValueError``)."""
    names = sorted(os.listdir(directory))[:n_images]
    for name in names:
        check_readable(os.path.join(directory, name))
    return names


def dir_batches(directory: str, names: List[str], batch: int,
                img_size: Optional[int] = None) -> Iterator[np.ndarray]:
    """Batches of the named images, LANCZOS-resized to ``img_size``² when
    given (PIL's ``resize``; an image already at that size is unchanged)."""
    for i in range(0, len(names), batch):
        imgs = []
        for name in names[i:i + batch]:
            img = load_image(os.path.join(directory, name))
            if img_size is not None:
                img = resize(img, (img_size, img_size), "lanczos")
            imgs.append(img.astype(np.float32) / 127.5 - 1.0)
        yield np.stack(imgs)


def store_batches(store: str, img_size: int, n_images: int, batch: int) -> Iterator[np.ndarray]:
    """Batches of a record store's images at ``img_size``, unflipped."""
    from ..data import MultiResolutionDataset

    ds = MultiResolutionDataset(store, resolution=img_size)
    try:
        n = min(len(ds), n_images)
        for i in range(0, n, batch):
            yield np.stack([ds.image(j) for j in range(i, min(i + batch, n))])
    finally:
        ds.close()
