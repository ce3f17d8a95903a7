"""Glob-based image dataset of the GIRAFFE family, port of
``sdface_gan_tpu/data/images.py`` without PIL: files decoded by
``decode.decode_image`` (what PIL's ``Image.open(...).convert("RGB")``
gives, byte for byte) and resized by ``resample.resize`` (PIL's LANCZOS,
bit-exact).  Optional celebA centre crop (108, or 650 for ``.npy``),
random or centre crop to a square, hflip, output in [0, 1] (or [-1, 1]
with ``use_tanh_range``), a corrupt file replaced by a random other one
drawn from the same numpy ``Generator``.  NHWC float32.

A ``.npy`` file holds an array (the first of a 4-D stack; CHW is turned to
HWC), clipped and cast to uint8: [H, W] (grey, given as it is) or
[H, W, 3]; other channel counts raise, as PIL's ``Image.fromarray`` does
for one channel (two and four channels, which PIL resizes with
premultiplied alpha, are refused too).
"""

from __future__ import annotations

import glob
from typing import Optional

import numpy as np

from .decode import decode_image
from .resample import resize


def _load(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.ndim == 4:
            arr = arr[0]
        if arr.shape[0] in (1, 3):  # CHW -> HWC
            arr = np.transpose(arr, (1, 2, 0))
        arr = np.clip(arr, 0, 255).astype(np.uint8)
        if not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
            raise ValueError(f"{path}: an array of shape {arr.shape} is not an image")
        return arr
    with open(path, "rb") as f:
        return decode_image(f.read())


class ImagesDataset:
    def __init__(self, path_glob: str, size: int = 64, celebA_center_crop: bool = False,
                 random_crop: bool = False, use_tanh_range: bool = False, hflip: bool = True):
        self.files = sorted(glob.glob(path_glob))
        if not self.files:
            raise IOError(f"no images match {path_glob}")
        self.size = size
        self.celebA_center_crop = celebA_center_crop
        self.random_crop = random_crop
        self.use_tanh_range = use_tanh_range
        self.hflip = hflip

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        for _ in range(10):
            try:
                img = _load(self.files[index])
                break
            except Exception:
                index = int(rng.integers(len(self.files)))
        else:
            raise IOError("too many corrupt images")

        h, w = img.shape[:2]
        if self.celebA_center_crop:
            crop = min(650 if self.files[index].endswith(".npy") else 108, w, h)
            left, top = (w - crop) // 2, (h - crop) // 2
        elif self.random_crop:
            crop = min(w, h)
            left = int(rng.integers(0, w - crop + 1))
            top = int(rng.integers(0, h - crop + 1))
        else:
            crop = min(w, h)
            left, top = (w - crop) // 2, (h - crop) // 2
        img = resize(img[top:top + crop, left:left + crop], (self.size, self.size), "lanczos")
        if self.hflip and rng.random() > 0.5:
            img = img[:, ::-1]
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if self.use_tanh_range:
            arr = arr * 2.0 - 1.0
        return arr


class ImagesLoader:
    """Infinite shuffled batch iterator over an :class:`ImagesDataset`."""

    def __init__(self, dataset: ImagesDataset, batch_size: int, seed: int):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        epoch = 0
        while True:
            order = np.arange(len(self.dataset))
            np.random.default_rng(self.seed + epoch).shuffle(order)
            n_full = len(order) // self.batch_size
            for b in range(max(n_full, 1)):
                sel = order[b * self.batch_size:(b + 1) * self.batch_size]
                if len(sel) < self.batch_size:
                    sel = np.resize(sel, self.batch_size)
                yield np.stack([self.dataset.__getitem__(int(i), rng) for i in sel])
            epoch += 1
