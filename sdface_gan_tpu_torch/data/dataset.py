"""Datasets over the record store, port of ``sdface_gan_tpu/data/dataset.py``
(``resolve_record_dir``, ``_open_store``, ``MultiResolutionDataset``,
``LSUNClass``).

Records keyed ``f"{size}-{idx:05d}"`` hold PNG images; ``__getitem__``
returns the image at the training resolution and a thumb made from it with
HAMMING, both h-flipped together when the caller's generator draws
``random() > 0.5``, as HWC float32 in [-1, 1].  PIL is replaced by the
port's PNG decoder (``png.py``) and PIL-exact resampler (``resample.py``).

``LSUNClass`` (the GIRAFFE family's LSUN-style dataset) reads records keyed
by a zero-padded index, decodes any image kind the port reads
(``decode.py``), centre-crops to the shorter side, resizes with LANCZOS and
h-flips on the caller's draw, giving HWC float32 in [0, 1] (or [-1, 1]).
"""

from __future__ import annotations

import glob as _glob
import os
from typing import Optional, Tuple

import numpy as np

from ..native import RecordReader
from .decode import decode_image
from .png import decode_png
from .resample import resize


def resolve_record_dir(yaml_path: str) -> str:
    """Resolve a yaml ``data.path`` to a record-store directory: the store
    dir itself, a parent containing ``records/``, or a glob whose dirname
    is either."""

    def is_store(d: str) -> bool:
        return os.path.isfile(os.path.join(d, "index.bin"))

    for cand in (yaml_path, os.path.join(yaml_path, "records"),
                 os.path.dirname(yaml_path),
                 os.path.join(os.path.dirname(yaml_path), "records")):
        if cand and is_store(cand):
            return cand
    return yaml_path if not _glob.has_magic(yaml_path) else os.path.dirname(yaml_path)


def _open_store(path: str) -> RecordReader:
    """Open a record store, naming the layouts ``resolve_record_dir`` probes
    when it is missing."""
    try:
        return RecordReader(path)
    except IOError as e:
        raise IOError(
            f"no record store under {path!r} (need index.bin/data.bin as "
            "written by prepare_data; the yaml data.path may be the "
            "store dir itself, a parent containing records/, or an image "
            "glob whose dirname is either — run "
            "python -m sdface_gan_tpu_torch.prepare_data first if this "
            "checkout has no prepared dataset)"
        ) from e


class MultiResolutionDataset:
    def __init__(
        self,
        path: str,
        resolution: int = 256,
        nerf_resolution: int = 64,
    ):
        self.reader = _open_store(path)
        length = self.reader.get("length")
        if length is None:
            raise IOError(f"record store at {path} has no 'length' key")
        self.length = int(length.decode())
        self.resolution = resolution
        self.nerf_resolution = nerf_resolution

    def __len__(self) -> int:
        return self.length

    def _decode(self, index: int) -> np.ndarray:
        key = f"{self.resolution}-{str(index).zfill(5)}"
        data = self.reader.get(key)
        if data is None:
            raise KeyError(key)
        return decode_png(data)

    def image(self, index: int) -> np.ndarray:
        """Record ``index`` at the training resolution, unflipped, HWC
        float32 in [-1, 1] (what FID scores a store by)."""
        return self._to_array(self._decode(index))

    def __getitem__(
        self, index: int, rng: Optional[np.random.Generator] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        img = self._decode(index)

        rng = rng or np.random.default_rng()
        if rng.random() > 0.5:
            img = img[:, ::-1]

        n = self.nerf_resolution
        thumb = resize(img, (n, n), "hamming")
        return self._to_array(img), self._to_array(thumb)

    @staticmethod
    def _to_array(img: np.ndarray) -> np.ndarray:
        """uint8 HWC -> float32 [-1, 1] HWC (torch Normalize(0.5, 0.5))."""
        arr = np.asarray(img, dtype=np.float32) / 255.0
        return arr * 2.0 - 1.0

    def close(self) -> None:
        self.reader.close()


class LSUNClass:
    """LSUN-style dataset over the record store (reference ``LSUNClass``,
    ``im2scene/data/datasets.py:20-101``, over LSUN's LMDB; archives are
    converted into a store whose keys are ``f"{prefix}{index:0{key_width}d}"``).
    The length is the store's ``length`` record, else its record count.  A
    missing key is retried at an index drawn from the caller's generator, up
    to 10 tries in all; then it raises."""

    TRIES = 10

    def __init__(self, path: str, size: int = 64, use_tanh_range: bool = False,
                 hflip: bool = True, key_width: int = 5, resolution_prefix: str = ""):
        self.reader = _open_store(path)
        length = self.reader.get("length")
        self.length = int(length.decode()) if length else len(self.reader)
        self.size = size
        self.use_tanh_range = use_tanh_range
        self.hflip = hflip
        self.key_width = key_width
        self.prefix = resolution_prefix

    def __len__(self) -> int:
        return self.length

    def _key(self, index: int) -> str:
        return f"{self.prefix}{str(index).zfill(self.key_width)}"

    def __getitem__(self, index: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        tried = []
        for _ in range(self.TRIES):
            tried.append(self._key(index))
            data = self.reader.get(tried[-1])
            if data is not None:
                break
            index = int(rng.integers(self.length))
        else:
            raise KeyError(f"no record under any of the {self.TRIES} keys tried: {tried}")
        img = decode_image(data)
        h, w = img.shape[:2]
        crop = min(w, h)
        left, top = (w - crop) // 2, (h - crop) // 2
        img = resize(img[top:top + crop, left:left + crop], (self.size, self.size), "lanczos")
        if self.hflip and rng.random() > 0.5:
            img = img[:, ::-1]
        arr = np.asarray(img, dtype=np.float32) / 255.0
        if self.use_tanh_range:
            arr = arr * 2.0 - 1.0
        return arr

    def close(self) -> None:
        self.reader.close()
