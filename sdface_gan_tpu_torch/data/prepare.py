"""Dataset preparation: image folder -> multi-resolution record store.
Port of ``sdface_gan_tpu/data/prepare.py`` (``prepare_data``,
``list_images``).

Each image's shorter side is resized to every requested size with LANCZOS
(PIL-exact, ``resample.py``), the result center-cropped, encoded as PNG
(``png.py``) and stored under ``f"{size}-{idx:05d}"``, with a final
``length`` record.  Resizing fans out over a process pool; the single
writer appends in order.  A folder is listed as the JAX package lists it
(PNG, JPEG, WebP, BMP, by extension); each file is decoded by its content
(``decode.py``: PNG, JPEG, WebP, BMP, as PIL decodes them), and a folder
holding a file the port does not read (a kind PIL refuses too, or a
corrupt one) raises before anything is written.  ``.npy`` arrays
([H, W] or [H, W, 3 or 4] uint8) are listed and read only on request
(``npy=True``): the JAX package skips them.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

from ..native import RecordWriter
from .decode import check_image, decode_image
from .png import encode_png
from .resample import resize

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")  # the JAX package's listing


def check_readable(path: str, npy: bool = False) -> None:
    """Raise ``ValueError`` unless the port reads ``path``: an image whose
    header :func:`check_image` accepts (PNG, JPEG, WebP, BMP, by
    content), or a ``.npy`` array when ``npy`` asks for it
    (``prepare_data`` only)."""
    if os.path.splitext(path)[1].lower() == ".npy":
        if npy:
            return
        raise ValueError(f"{path}: .npy input is read only by prepare_data on request "
                         "(npy=True, or --npy on its command line); the JAX package reads "
                         "image files only")
    with open(path, "rb") as f:
        data = f.read()
    try:
        check_image(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def load_image(path: str) -> np.ndarray:
    """An image file (PNG, JPEG, WebP or BMP) -> [H, W, 3] uint8 RGB."""
    if os.path.splitext(path)[1].lower() == ".npy":
        check_readable(path)  # raises: arrays are read only by prepare_data, on request
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_image(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def load_array(path: str) -> np.ndarray:
    """A ``.npy`` array ([H, W] or [H, W, 3 or 4] uint8) -> [H, W, 3] uint8 RGB."""
    arr = np.load(path, allow_pickle=False)
    if arr.dtype != np.uint8 or not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] in (3, 4))):
        raise ValueError(f"{path}: expected [H, W] or [H, W, 3|4] uint8, "
                         f"got {arr.dtype} {arr.shape}")
    if arr.ndim == 2:
        return np.repeat(arr[..., None], 3, axis=-1)
    return np.ascontiguousarray(arr[..., :3])


def _resize_one(args: Tuple[int, str, Sequence[int]]) -> Tuple[int, List[bytes]]:
    idx, path, sizes = args
    img = load_array(path) if path.lower().endswith(".npy") else load_image(path)
    outs = []
    for size in sizes:
        # shorter side to `size`, then center crop (torchvision Resize +
        # CenterCrop semantics, as the JAX package resizes)
        h, w = img.shape[:2]
        if w <= h:
            nw, nh = size, max(size, round(size * h / w))
        else:
            nw, nh = max(size, round(size * w / h)), size
        resized = resize(img, (nw, nh), "lanczos")
        left = (nw - size) // 2
        top = (nh - size) // 2
        outs.append(encode_png(resized[top:top + size, left:left + size]))
    return idx, outs


def list_images(in_dir: str, npy: bool = False) -> List[str]:
    """The image files under ``in_dir``, sorted; ``.npy`` files too when ``npy``."""
    exts = IMAGE_EXTS + ((".npy",) if npy else ())
    files = []
    for root, _, names in os.walk(in_dir):
        for n in sorted(names):
            if n.lower().endswith(exts):
                files.append(os.path.join(root, n))
    files.sort()
    return files


def prepare_data(
    in_dir: str,
    out_path: str,
    sizes: Sequence[int] = (64, 128, 256, 512, 1024),
    n_workers: int = 8,
    npy: bool = False,
) -> int:
    """Build the record store.  Returns the number of images written.
    ``npy`` also takes the folder's ``.npy`` arrays, in the sorted order."""
    files = list_images(in_dir, npy)
    for f in files:
        check_readable(f, npy)  # raises before anything is written
    jobs = [(i, f, tuple(sizes)) for i, f in enumerate(files)]
    results: dict = {}
    with RecordWriter(out_path) as writer:
        if n_workers > 1 and len(jobs) > 1:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=n_workers, mp_context=ctx) as pool:
                for idx, blobs in pool.map(_resize_one, jobs, chunksize=8):
                    results[idx] = blobs
        else:
            for job in jobs:
                idx, blobs = _resize_one(job)
                results[idx] = blobs
        for idx in range(len(files)):
            for size, blob in zip(sizes, results[idx]):
                writer.put(f"{size}-{str(idx).zfill(5)}", blob)
        writer.put("length", str(len(files)).encode())
    return len(files)
