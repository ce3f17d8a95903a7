"""PIL's ``Image.resize`` with ``HAMMING`` and ``LANCZOS`` on 8-bit images,
bit for bit, in numpy.

The JAX package resizes with PIL: the 64^2 thumb with ``Image.HAMMING``
(``sdface_gan_tpu/data/dataset.py``) and the prepared records with
``Image.LANCZOS`` (``sdface_gan_tpu/data/prepare.py``).  This reproduces
Pillow's ``libImaging/Resample.c`` for those calls (whole-image box, no
``reducing_gap``):

* pixel-centre coordinates, the filter's support scaled by the reduction
  factor (HAMMING support 1, LANCZOS 3);
* per output pixel, the taps normalised to sum 1, then made fixed-point
  with 22 precision bits and rounded half away from zero;
* the horizontal pass first, then the vertical, each rounding with
  ``+ (1 << 21) >> 22`` and clipping to uint8; a pass whose size does not
  change is skipped.

Each pass is one matrix product of the integer taps with the uint8 pixels.
It runs in float64, which is exact here: every product and partial sum is
an integer below 255 * 2^22 * (taps per output) < 2^53.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np

PRECISION_BITS = 22
# Pillow writes the Hamming window's constants as float literals
_H0, _H1 = float(np.float32(0.54)), float(np.float32(0.46))


def _hamming(x: float) -> float:
    x = abs(x)
    if x == 0.0:
        return 1.0
    if x >= 1.0:
        return 0.0
    x = x * math.pi
    return math.sin(x) / x * (_H0 + _H1 * math.cos(x))


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


FILTERS = {"hamming": (_hamming, 1.0), "lanczos": (_lanczos, 3.0)}


@lru_cache(maxsize=64)
def taps(in_size: int, out_size: int, name: str) -> np.ndarray:
    """[out_size, in_size] fixed-point taps of one pass (Pillow's
    ``precompute_coeffs`` and ``normalize_coeffs_8bpc``), as float64.
    Read-only: the cache hands the same array to every caller."""
    fn, support = FILTERS[name]
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = support * filterscale
    ss = 1.0 / filterscale
    out = np.zeros((out_size, in_size), dtype=np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:  # a plain left-to-right sum, as the C loop adds (not sum())
            ww += w
        for x, w in enumerate(k):
            if ww != 0.0:
                w /= ww
            fixed = w * (1 << PRECISION_BITS)
            out[xx, xmin + x] = int(fixed - 0.5) if w < 0 else int(fixed + 0.5)
    out.setflags(write=False)
    return out


def _apply(m: np.ndarray, x: np.ndarray) -> np.ndarray:
    """One pass along axis 0 of ``x`` [in, ...] -> [out, ...] uint8."""
    acc = (m @ x.reshape(x.shape[0], -1).astype(np.float64)).astype(np.int64)
    acc = (acc + (1 << (PRECISION_BITS - 1))) >> PRECISION_BITS
    return np.clip(acc, 0, 255).astype(np.uint8).reshape((m.shape[0],) + x.shape[1:])


def resize(img: np.ndarray, size: Tuple[int, int], name: str) -> np.ndarray:
    """``Image.fromarray(img).resize(size, <name>)`` for an [H, W] or
    [H, W, C] uint8 image; ``size`` is (width, height) as PIL takes it and
    ``name`` is ``"hamming"`` or ``"lanczos"``."""
    if img.dtype != np.uint8:
        raise ValueError(f"expected a uint8 image, got {img.dtype}")
    if name not in FILTERS:
        raise ValueError(f"unknown filter {name!r}; expected one of {sorted(FILTERS)}")
    out_w, out_h = size
    h, w = img.shape[:2]
    if out_w < 1 or out_h < 1:
        raise ValueError(f"output size {size} must be positive")
    out = img
    if out_w != w:  # horizontal pass: along axis 1
        out = np.swapaxes(_apply(taps(w, out_w, name), np.swapaxes(out, 0, 1)), 0, 1)
    if out_h != h:
        out = _apply(taps(h, out_h, name), out)
    return np.ascontiguousarray(out)
