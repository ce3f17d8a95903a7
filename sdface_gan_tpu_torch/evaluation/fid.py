"""FID and KID, port of ``sdface_gan_tpu/evaluation/fid.py``.

Rebuild of the reference FID core (``im2scene/eval.py:22-192``) with its
broken in-script tail fixed: activations -> statistics -> Frechet
distance, plus KID (polynomial-kernel MMD, the ``torch-fidelity``
default).  The activations batch on the Inception's device; the
statistics are numpy and scipy on the host, the JAX package's code with
the same seeds, warnings and errors.
"""

from __future__ import annotations

import warnings
from typing import Iterable, Tuple, Union

import numpy as np
import torch

ImageBatch = Union[np.ndarray, torch.Tensor]


def compute_activations(
    model,
    images: Iterable[ImageBatch],
    batch_size: int = 50,
) -> np.ndarray:
    """pool3 activations [N, 2048] for an iterable of [n, H, W, 3] batches
    in [-1, 1] (numpy arrays or tensors, on any device), regrouped into
    batches of ``batch_size`` on the model's device."""
    device = next(model.parameters()).device
    outs = []
    pending: list = []
    n_pending = 0

    def flush(chunk: torch.Tensor) -> None:
        with torch.no_grad():
            outs.append(model(chunk).cpu().numpy())

    for arr in images:
        t = torch.as_tensor(arr).to(device=device, dtype=torch.float32)
        pending.append(t)
        n_pending += len(t)
        while n_pending >= batch_size:
            flat = torch.cat(pending, 0)
            flush(flat[:batch_size])
            rest = flat[batch_size:]
            pending = [rest] if len(rest) else []
            n_pending = len(rest)
    if n_pending:
        flush(torch.cat(pending, 0))
    return np.concatenate(outs, axis=0)


def calculate_activation_statistics(acts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of activations (reference ``eval.py:163-192``)."""
    mu = np.mean(acts, axis=0)
    sigma = np.cov(acts, rowvar=False)
    return mu, sigma


def calculate_frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray,
    mu2: np.ndarray, sigma2: np.ndarray,
    eps: float = 1e-6,
) -> float:
    """Frechet distance with the sqrtm stabilization of the reference
    (``im2scene/eval.py:107-160``): offset the diagonal if sqrtm produces
    non-finite values; strip negligible imaginary parts, raise
    ``ValueError`` on a large one."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            m = np.max(np.abs(covmean.imag))
            raise ValueError(f"Imaginary component {m}")
        covmean = covmean.real

    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def calculate_kid(
    acts1: np.ndarray,
    acts2: np.ndarray,
    n_subsets: int = 100,
    subset_size: int = 1000,
    seed: int = 0,
) -> Tuple[float, float]:
    """Kernel Inception Distance (polynomial kernel MMD^2, torch-fidelity
    defaults: kernel (x.y/d + 1)^3, 100 subsets of 1000).

    Returns (mean, std) across subsets.
    """
    rng = np.random.default_rng(seed)
    n = min(len(acts1), len(acts2))
    m = min(subset_size, n)
    d = acts1.shape[1]
    scores = []
    for _ in range(n_subsets):
        x = acts1[rng.choice(len(acts1), m, replace=False)].astype(np.float64)
        y = acts2[rng.choice(len(acts2), m, replace=False)].astype(np.float64)
        kxx = (x @ x.T / d + 1.0) ** 3
        kyy = (y @ y.T / d + 1.0) ** 3
        kxy = (x @ y.T / d + 1.0) ** 3
        sum_kxx = (kxx.sum() - np.trace(kxx)) / (m * (m - 1))
        sum_kyy = (kyy.sum() - np.trace(kyy)) / (m * (m - 1))
        sum_kxy = kxy.mean()
        scores.append(sum_kxx + sum_kyy - 2 * sum_kxy)
    return float(np.mean(scores)), float(np.std(scores))


def fid_from_activations(acts1: np.ndarray, acts2: np.ndarray) -> float:
    mu1, s1 = calculate_activation_statistics(acts1)
    mu2, s2 = calculate_activation_statistics(acts2)
    return calculate_frechet_distance(mu1, s1, mu2, s2)


def load_stats_npz(
    path: str, expect_img_size: "int | None" = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Load precomputed (mu, sigma) stats (the reference ``fid_file`` .npz,
    keys ``mu``/``sigma`` or ``m``/``s``).

    ``expect_img_size``: the resolution of the images being scored.  Stats
    written by ``calc_fid_stats`` record their ``img_size``; activations of
    differently sized inputs give a meaningless FID (the Inception's resize
    differs), so a recorded mismatch warns.
    """
    with np.load(path) as f:
        if expect_img_size is not None and "img_size" in f:
            stored = int(f["img_size"])
            if stored != expect_img_size:
                warnings.warn(
                    f"FID stats in {path} were computed at img_size={stored} "
                    f"but the scored images are {expect_img_size}px — the "
                    "resulting FID is not meaningful; regenerate the stats "
                    f"with --img_size {expect_img_size}."
                )
        if "mu" in f:
            return f["mu"], f["sigma"]
        return f["m"], f["s"]
