"""Real spherical-harmonics direction encoding.

Port of ``sdface_gan_tpu/ops/sh_encoder.py``: the first ``degree**2`` real
SH basis values of a direction, from the standard recurrences evaluated on
Python floats, so each component is a flat polynomial of elementwise ops.
No kernel: the polynomials are a handful of elementwise passes that feed
the views GEMM.

* ``C_m + i S_m = (x + i y)^m`` gives ``sin^m(theta) (cos, sin)(m phi)``;
* ``P_l^m / sin^m(theta)`` by the three-term recurrence in z;
* ``K(l, m) = sqrt((2l+1)/(4 pi) (l-m)!/(l+m)!)`` with the Condon-Shortley
  phase ``(-1)^m`` (band 1 is ``(-y, z, -x)``), components ordered
  ``m = -l .. l``.
"""

from __future__ import annotations

import math

import torch

MAX_DEGREE = 8


def _k(l: int, m: int) -> float:
    """SH normalization constant K(l, m)."""
    return math.sqrt(
        (2 * l + 1) / (4.0 * math.pi) * math.factorial(l - m) / math.factorial(l + m)
    )


def sh_encode(dirs: torch.Tensor, degree: int = 4, size: float = 1.0) -> torch.Tensor:
    """[..., 3] directions in [-size, size]^3 -> [..., degree**2] basis values."""
    if not 1 <= degree <= MAX_DEGREE:
        raise NotImplementedError(
            f"sh_encode supports degree in [1, {MAX_DEGREE}], got {degree}")
    d = dirs / size
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    lmax = degree - 1

    C = [torch.ones_like(x)]
    S = [torch.zeros_like(x)]
    for m in range(1, lmax + 1):
        C.append(x * C[m - 1] - y * S[m - 1])
        S.append(x * S[m - 1] + y * C[m - 1])

    # P[(l, m)] = P_l^m(z) / sin^m(theta), without the Condon-Shortley phase
    P = {(0, 0): torch.ones_like(z)}
    for m in range(0, lmax + 1):
        if m > 0:
            P[(m, m)] = (2 * m - 1) * P[(m - 1, m - 1)]
        if m + 1 <= lmax:
            P[(m + 1, m)] = (2 * m + 1) * z * P[(m, m)]
        for l in range(m + 2, lmax + 1):
            P[(l, m)] = (
                (2 * l - 1) * z * P[(l - 1, m)] - (l + m - 1) * P[(l - 2, m)]
            ) / (l - m)

    comps = []
    for l in range(0, lmax + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            if m == 0:
                comps.append(_k(l, 0) * P[(l, 0)])
            else:
                coef = (-1.0) ** am * math.sqrt(2.0) * _k(l, am)
                circ = S[am] if m < 0 else C[am]
                comps.append(coef * circ * P[(l, am)])
    return torch.stack(comps, -1)


def sh_output_dim(degree: int) -> int:
    return degree * degree
